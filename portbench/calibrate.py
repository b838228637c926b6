"""The readings a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--seconds 2] [--control-seeds 7,8,9]

For each of ``--seeds``, one run of the cell as ``run.py`` makes it, with
a short window, and its numbers compared (the lower readings: what sound
runs of the port give). For each of ``--control-seeds``, the same run
with the control in the port's step's place (the configuration's
reference one precision lower, ``control_step``), judged by the same
``harness.judge`` (the upper readings; each must read not correct). One
JSON line each; the limits in the configuration's file are set between
the largest lower and the smallest upper reading.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def control_in_place(config: dict):
    """The port's ``make_multi_station_step``, which both loops build their
    step with, gives the control's step and state instead."""
    from portbench import harness
    from radiocore_tpu_torch.parallel import pipeline
    ref = harness.reference(config["reference"])
    make = pipeline.make_multi_station_step

    def make_control(*args, device=None, **kwargs):
        return ref.control_step(config, torch.device(device))

    pipeline.make_multi_station_step = make_control
    try:
        yield
    finally:
        pipeline.make_multi_station_step = make


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()

    from portbench import harness
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    device = torch.device("cuda", 0)
    bench = harness.load_benchmark(ROOT)
    work = harness.find(bench["workloads"], args.workload, "workload")
    config = harness.load_config(ROOT, bench, work["config"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    lower, upper = {}, {}
    for seed in seeds:
        r = harness.run_cell(ROOT, bench, args.workload, seed, args.seconds,
                             False, device, time.perf_counter())
        gaps = {k: c["value"] for k, c in r["checks"].items()}
        for k, v in gaps.items():
            lower[k] = max(lower.get(k, 0.0), v)
        print(json.dumps({"kind": "program", "seed": seed, **gaps,
                          "correct": r["correct"]}), flush=True)
        torch.cuda.empty_cache()
    for seed in controls:
        with control_in_place(config):
            r = harness.run_cell(ROOT, bench, args.workload, seed,
                                 args.seconds, False, device,
                                 time.perf_counter())
        gaps = {k: c["value"] for k, c in r["checks"].items()}
        for k, v in gaps.items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"kind": "control", "seed": seed, **gaps,
                          "correct": r["correct"]}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "limits": config["limits"],
                      "seconds": time.perf_counter() - CLOCK0}), flush=True)


if __name__ == "__main__":
    main()

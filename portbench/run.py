"""Run one cell of the port's benchmark on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit); the last lines of standard error
repeat the checks. Without a CUDA card, with fewer cards than the cell
asks for, on a card whose peaks ``portbench/roofline.py`` does not know,
or when JAX or the JAX package has been loaded, it prints no result and
exits with a code other than 0.
"""

import time

CLOCK0 = time.perf_counter()   # set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout, so that only
# a cell's first run there builds (the port builds its kernels into its
# own ``radiocore_tpu_torch/_build``).
CACHE = ROOT / ".portbench_cache"


def prepare_process() -> None:
    """Before torch is imported: the caches, the import path, and one
    process on a fixed half of the cores it may use, so that torch's
    threads and the host's share of a run stay on the same cores from
    run to run."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[:max(1, len(cores) // 2)])


def fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    prepare_process()
    import torch
    from portbench import harness, roofline

    bench = harness.load_benchmark(ROOT)
    work = harness.find(bench["workloads"], args.workload, "workload")
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card only", 2)
    if torch.cuda.device_count() < int(work["chips"]):
        fail(f"{args.workload} needs {work['chips']} cards, "
             f"{torch.cuda.device_count()} seen", 2)
    device = torch.device("cuda", 0)
    try:
        roofline.peaks(torch.cuda.get_device_name(device))
    except roofline.UnknownCard as e:
        fail(str(e), 2)

    result = harness.run_cell(ROOT, bench, args.workload, args.seed,
                              args.seconds, bool(args.trace), device, CLOCK0)
    found = harness.forbidden_modules()
    if found:
        fail(f"loaded modules that the benchmark must not load: {found}", 3)
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""Schedule sweep of K-EXTRACT, K-XDEMOD and K-XDEMOD-SPEC on one NVIDIA
GPU, and what the schedule is worth to a whole step.

Run from the root of a checkout:
``python3 -m radiocore_tpu_torch.tools.extract_sweep [--steps-only]``.
It builds the port's kernels and times

- every schedule of each kernel: stations per group G over one to three
  lanes (streams with a scratch set each), and the passes over the whole
  batch (G = c), median of 20 CUDA-event timings;
- the steps that run K-EXTRACT and K-XDEMOD (``make_multi_station_step``:
  64 stations ``off``, 96 stations ``fused`` and ``off``) at the default
  grouped schedule against the same step with the passes over the whole
  batch, in turns (grouped, whole, whole, grouped), median of 20 steps
  each turn.

Shapes are those of ``chip_smoke.py`` (64 x 2^18 from a 2^24 band; 96 x
2^18 from a 96 * 2^18 band, 63 601 bins kept); the bands are noise (the
times do not depend on the data; ``chip_smoke.py`` holds the results
against their references). Prints the card's name and power limit first;
every time is that card's.
"""

from __future__ import annotations

import argparse
import math
import statistics
import sys

GROUPS = (1, 2, 4, 8, 16, 32)
LANES = (1, 2, 3)
STATION = 262_144
AUDIO = 49_152
SEED = 1234


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def offsets(c: int, sc: int):
    half = c * sc // 2 - sc // 2
    return [int(-half + i * sc) for i in range(c)]


def sweep_kernels(device, gen) -> None:
    import torch
    from radiocore_tpu_torch.kernels import extract, extract_demod
    from radiocore_tpu_torch.models.wbfm import make_wbfm_step

    m = STATION
    gain = 1.0 / math.pi
    keep = int(make_wbfm_step(m, AUDIO, mode="fast_spec").needed_bins)

    def sweep(what, c, kernel):
        for lanes in LANES:
            times = [f"G={g} {time_ms(lambda: kernel(g, lanes)):.3f}"
                     for g in (*[g for g in GROUPS if g < c], c)]
            print(f"[sweep] {what} lanes={lanes}: " + ", ".join(times))

    for c in (64, 96):
        n = c * m
        band = torch.complex(torch.randn(n, generator=gen, device=device),
                             torch.randn(n, generator=gen, device=device))
        sweep(f"K-EXTRACT {c}x2^18", c,
              lambda g, lanes: extract.extract_rows_kernel(
                  band, n // 2, c, m, 1.0 / n, group=g, lanes=lanes))
    sweep("K-XDEMOD 96x2^18", c,
          lambda g, lanes: extract_demod.extract_demod_kernel(
              band, n // 2, c, m, gain, None, group=g, lanes=lanes))
    sweep(f"K-XDEMOD-SPEC 96x2^18 keep {keep}", c,
          lambda g, lanes: extract_demod.extract_demod_kernel(
              band, n // 2, c, m, gain, keep, group=g, lanes=lanes))


def compare_steps(device, gen) -> None:
    """Each step at the default schedule and with the passes over the
    whole batch (``extract.grouped_schedule`` replaced for the turn). A
    step's CUDA graph keeps the schedule it was captured with, so each
    turn builds and captures its own step."""
    import torch
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step

    default = extract.grouped_schedule

    def whole_batch(device, m, buffers, c):
        return c, 1

    for c, mode in ((64, "off"), (96, "fused"), (96, "off")):
        n = c * STATION
        band = torch.complex(torch.randn(n, generator=gen, device=device),
                             torch.randn(n, generator=gen, device=device))
        times = []
        for schedule in (default, whole_batch, whole_batch, default):
            extract.grouped_schedule = schedule
            try:
                step, state = make_multi_station_step(
                    n, offsets(c, STATION), STATION, AUDIO, mode="fast",
                    extract_demod=mode, device=device)
                times.append(time_ms(lambda: step(band, state)))
            finally:
                extract.grouped_schedule = default
            del step, state
        g1, w1, w2, g2 = times
        print(f"[step] {c} stations {mode}: grouped {g1:.3f} / {g2:.3f} ms, "
              f"whole batch {w1:.3f} / {w2:.3f} ms")
        del band


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps-only", action="store_true")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("extract_sweep: no CUDA device", file=sys.stderr)
        return 2
    from radiocore_tpu_torch.kernels import build, extract
    from radiocore_tpu_torch.runtime.platform import nvidia_smi_name_power

    print(nvidia_smi_name_power().splitlines()[0])
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    print(f"L2 {extract.l2_cache_bytes(0)} bytes; grouped schedule (G, "
          f"lanes): one scratch buffer "
          f"{extract.grouped_schedule(device, STATION, 1, 96)}, two "
          f"{extract.grouped_schedule(device, STATION, 2, 96)}")
    compare_steps(device, gen)
    if not args.steps_only:
        sweep_kernels(device, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())

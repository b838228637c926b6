"""K-FIR on one NVIDIA GPU: its device time over tap counts and shapes, and
whether the two stereo legs' de-emphasis should be one launch.

Run from the root of a checkout: ``python3 -m
radiocore_tpu_torch.tools.fir_sweep``. It builds the port's kernels and
prints

- K-FIR's device time (``torch.profiler``, mean of 30 calls) and the time
  between CUDA events around single calls (min and median of 50: the
  host's enqueue, where that is the longer) for 51 and 129 taps at
  128 x 49 152 and 32 x 262 144, beside ``conv1d`` (TF32 off) on the same
  rows;
- the de-emphasis of both stereo legs of 64 and of 96 stations, as
  ``models/wbfm.py`` runs it (one launch over all ``2 x stations`` rows of
  the ``(stations, 2, 49 152)`` tensor, the two histories stacked first)
  against one launch per leg, each with its own history: the device time
  of every kernel involved, summed, in turns (two, one, one, two).

Prints the card's name and power limit first; every time is that card's.
"""

from __future__ import annotations

import statistics
import sys

AUDIO = 49_152
STATION = 262_144
SEED = 1234


def device_ms(fn, reps: int = 30) -> float:
    """Device time of all kernels of one ``fn()`` call, from
    ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(ev.time_range.end - ev.time_range.start
               for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA)
    if not busy > 0:
        raise AssertionError("the profiler saw no device time")
    return busy / reps / 1e3


def event_ms(fn, reps: int = 50):
    """Min and median of CUDA-event timings around single ``fn()`` calls."""
    import torch
    for _ in range(3):
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
    ms = [s.elapsed_time(e) for s, e in pairs]
    return min(ms), statistics.median(ms)


def sweep_shapes(device, gen) -> None:
    import torch
    from scipy import signal
    from radiocore_tpu_torch.kernels import fir
    from radiocore_tpu_torch.ops.design import deemphasis_taps

    for taps in (deemphasis_taps(AUDIO), signal.firwin(129, 0.45)):
        for rows, n in ((128, AUDIO), (32, STATION)):
            x = torch.randn(rows, n, generator=gen, device=device)
            hist = torch.randn(rows, len(taps) - 1, generator=gen,
                               device=device)
            xp = torch.cat([hist, x], dim=-1)[:, None, :]
            weight = torch.tensor(taps[::-1].copy(), dtype=torch.float32,
                                  device=device)[None, None, :]
            dev = device_ms(lambda: fir.fir_causal_rows(x, taps, hist))
            lo, med = event_ms(lambda: fir.fir_causal_rows(x, taps, hist))
            conv = device_ms(lambda: torch.nn.functional.conv1d(xp, weight))
            print(f"[fir] {len(taps)} taps {rows}x{n}: device {dev:.4f} ms; "
                  f"between events min {lo:.4f} median {med:.4f} ms; conv1d "
                  f"device {conv:.4f} ms")


def compare_legs(device, gen) -> None:
    import torch
    from radiocore_tpu_torch.ops.deemphasis import (deemphasis_apply,
                                                    deemphasis_init)

    for c in (64, 96):
        taps, hist_l = deemphasis_init(AUDIO, batch_shape=(c,), device=device)
        hist_r = hist_l.clone()
        lr = torch.randn(c, 2, AUDIO, generator=gen, device=device)

        def two():
            l, h_l = deemphasis_apply(lr[..., 0, :], taps, hist_l)
            r, h_r = deemphasis_apply(lr[..., 1, :], taps, hist_r)
            return torch.stack([l, r], dim=-1), h_l, h_r

        def one():
            hist = torch.stack([hist_l, hist_r], dim=-2)
            y, h = deemphasis_apply(lr, taps, hist)
            return (torch.stack([y[..., 0, :], y[..., 1, :]], dim=-1),
                    h[..., 0, :], h[..., 1, :])

        a, b = two(), one()
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError("one launch and two give different results")
        t1, o1, o2, t2 = (device_ms(f) for f in (two, one, one, two))
        print(f"[legs] {c} stations, de-emphasis and stereo stack, device "
              f"time of all kernels: two launches {t1:.4f} / {t2:.4f} ms, "
              f"one launch over {2 * c} rows with stacked histories "
              f"{o1:.4f} / {o2:.4f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fir_sweep: no CUDA device", file=sys.stderr)
        return 2
    from radiocore_tpu_torch.kernels import build
    from radiocore_tpu_torch.runtime.platform import nvidia_smi_name_power

    print(nvidia_smi_name_power().splitlines()[0])
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(SEED)
    sweep_shapes(device, gen)
    compare_legs(device, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())

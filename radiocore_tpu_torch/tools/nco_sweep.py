"""K-NCO's design space on one NVIDIA GPU: its time over the tile length,
the L2 prefetch distance and the rows a block.

Run from the root of a checkout: ``python3 -m
radiocore_tpu_torch.tools.nco_sweep``. It writes variants of
``csrc/nco_pll.cu`` with ``kNcoTile``, ``kNcoAhead`` (0: no prefetch) and
the rows a block (None: the kernel's own rule, ``nco_lanes``) replaced,
builds them with ``nvcc`` (the flags of ``kernels/build.py``, all at once)
into a temporary directory under ``_build``, and prints for each its time
(CUDA events, median of 5) and cycles a sample at 64 x 262 144, at
64 x 262 143 with every row off a 16-byte boundary and at 2048 x 8192, and
whether its trajectory equals the shipped kernel's bit for bit. The first
variant is the shipped one.

Prints the card's name and power limit first; every time is that card's.
"""

from __future__ import annotations

import ctypes
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

STATION = 262_144
SEED = 1234

# (samples a tile, tiles between prefetch and use, rows a block).
VARIANTS = ((48, 8, None), (16, 0, 32), (16, 8, 32), (16, 8, None),
            (32, 8, None), (64, 8, None), (48, 0, None), (48, 8, 32))


def variant_source(src: str, tile: int, ahead: int,
                   lanes: Optional[int]) -> str:
    """``csrc/nco_pll.cu`` with the tile, the prefetch distance (0: a
    distance no row reaches) and the rows a block replaced; raises if the
    source no longer holds one of them."""
    subs = [(r"constexpr int kNcoTile = \d+;",
             f"constexpr int kNcoTile = {tile};"),
            (r"constexpr int kNcoAhead = \d+;",
             f"constexpr int kNcoAhead = {ahead if ahead else '1 << 30'};")]
    if lanes is not None:
        subs.append((re.escape("rc::nco_lanes(rows, sms)"), str(lanes)))
    for pattern, repl in subs:
        src, count = re.subn(pattern, repl, src)
        if count != 1:
            raise RuntimeError(f"nco_sweep: {pattern!r} found {count} times "
                               f"in csrc/nco_pll.cu")
    return src


def build_variants(work: Path):
    """Build every variant into ``work``; the loaded libraries in order."""
    from radiocore_tpu_torch.kernels import build
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    nvcc = build.find_nvcc()
    cmds, libs = [], []
    for i, (tile, ahead, lanes) in enumerate(VARIANTS):
        cu = work / f"nco_{i}.cu"
        cu.write_text(variant_source(src, tile, ahead, lanes))
        libs.append(work / f"libnco_{i}.so")
        cmds.append([nvcc, *build.COMPILE_FLAGS, "-shared", "-o",
                     str(libs[-1]), str(cu)])
    build._run_all(cmds)
    out = []
    for path in libs:
        fn = ctypes.CDLL(str(path)).rc_nco_pll
        fn.argtypes = build._SIGNATURES["rc_nco_pll"]
        fn.restype = ctypes.c_int
        out.append(fn)
    return out


def event_ms(fn, reps: int = 5) -> float:
    """Median of CUDA-event timings of single ``fn()`` calls."""
    import torch
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


def sweep(device, gen) -> None:
    import torch
    from radiocore_tpu_torch.kernels import build, nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import pll_design

    gains = pll_design(STATION, 19e3, 50.0)
    # 64 rms-normalised pilots, 19 kHz within +-3 Hz, noise at 0.1.
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(STATION + 4, **f64) / STATION
    f = 19e3 + 6.0 * (torch.rand(64, 1, generator=gen, **f64) - 0.5)
    phi = 2 * math.pi * torch.rand(64, 1, generator=gen, **f64)
    x = (math.sqrt(2.0) * torch.sin(2 * math.pi * f * t + phi)
         + 0.1 * torch.randn(64, t.numel(), generator=gen, **f64)).float()
    cases = {"64x262144": x[:, :STATION].contiguous(),
             "64x262143 off a 16-byte boundary": x[:, 1:STATION]}
    cases["2048x8192"] = cases["64x262144"].reshape(2048, 8192)
    zeros = {k: torch.zeros(v.shape[0], device=device)
             for k, v in cases.items()}
    shipped = {k: knco.nco_pll_track_rows(v, *gains, zeros[k], zeros[k])[0]
               for k, v in cases.items()}
    for _ in range(50):    # the clocks up before the first timing
        knco.nco_pll_track_rows(cases["64x262144"], *gains,
                                zeros["64x262144"], zeros["64x262144"])
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    try:
        fns = build_variants(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for (tile, ahead, lanes), fn in zip(VARIANTS, fns):
        line = []
        for what, v in cases.items():
            rows, n = v.shape
            traj = torch.empty(rows, n, device=device)
            state = torch.empty(2, rows, device=device)

            def run():
                build.check(fn(v.data_ptr(), v.stride(0),
                               zeros[what].data_ptr(), zeros[what].data_ptr(),
                               traj.data_ptr(), state[0].data_ptr(),
                               state[1].data_ptr(), rows, n, *gains,
                               torch.cuda.current_stream().cuda_stream),
                            "rc_nco_pll")
            ms = event_ms(run)
            same = bool(torch.equal(traj, shipped[what]))
            line.append(f"{what} {ms:.3f} ms ({ms * 1e3 * mhz / n:.1f} "
                        f"cycles a sample), equal to the shipped kernel: "
                        f"{same}")
        print(f"[nco_sweep] tile {tile}, prefetch "
              f"{f'{ahead} tiles ahead' if ahead else 'off'}, rows a block "
              f"{lanes or 'by nco_lanes'}: " + "; ".join(line), flush=True)
    print(f"[nco_sweep] cycles at {mhz:.0f} MHz (nvidia-smi clocks.sm "
          f"after the warm-up)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("nco_sweep: no CUDA device", file=sys.stderr)
        return 2
    from radiocore_tpu_torch.kernels import build
    from radiocore_tpu_torch.runtime.platform import nvidia_smi_name_power

    print(nvidia_smi_name_power().splitlines()[0])
    build.library()
    device = torch.device("cuda", 0)
    sweep(device, torch.Generator(device=device).manual_seed(SEED))
    return 0


if __name__ == "__main__":
    sys.exit(main())

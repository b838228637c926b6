"""K-NCO's block on one NVIDIA GPU: the kernel's time over the samples a
tile and the depth of the ring its helpers stage.

Run from the root of a checkout: ``python3 -m
radiocore_tpu_torch.tools.nco_sweep``. It writes variants of
``csrc/nco_pll.cu`` with ``kNcoPhasorTile`` and ``kNcoRing`` replaced by
each pair of :data:`VARIANTS`, builds them with ``nvcc`` (the flags of
``kernels/build.py``, all at once) into a temporary directory under
``_build``, and prints for each its time (CUDA events, median of 5),
cycles a sample and the tiles its chain lanes found not yet staged
(``starved``) at 24 x 240 000 (the ``wbfm24_pll`` cell's shape, the
subcarrier output), and whether its subcarrier equals the shipped
kernel's bit for bit (a tile of another length renormalises |w|
elsewhere, so only the shipped tile can). The first pair is the shipped
one. Before the variants it prints the cycles a link of each chain of
the shipped probe (``kernels/nco_pll.PROBE_CHAINS``) over 240 000 links,
one lane.

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

CELL = (24, 240_000)   # the wbfm24_pll cell's rows and samples a chunk
SEED = 1234

# (samples a tile, tiles in the ring), the shipped pair first; then the
# tile at the shipped ring, and the ring at the shipped tile. A tile past
# 88 samples no longer fits the probe's static shared memory.
VARIANTS = ((80, 4), (48, 4), (64, 4), (72, 4), (88, 4), (80, 2), (80, 3),
            (80, 6), (80, 8))


def variant_source(src: str, tile: int, ring: int) -> str:
    """``csrc/nco_pll.cu`` with ``tile`` samples a tile and ``ring`` tiles
    in the ring; raises if the source no longer holds either constant."""
    for name, value in (("kNcoPhasorTile", tile), ("kNcoRing", ring)):
        pattern = rf"constexpr int {name} = \d+;"
        src, count = re.subn(pattern, f"constexpr int {name} = {value};",
                             src)
        if count != 1:
            raise RuntimeError(f"nco_sweep: {pattern!r} found {count} times "
                               f"in csrc/nco_pll.cu")
    return src


def build_variants(work: Path):
    """Build the shipped source at each of :data:`VARIANTS` into
    ``work``; for each in order, its ``rc_nco_pll``."""
    from radiocore_tpu_torch.kernels import build
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    nvcc = build.find_nvcc()
    cmds, libs = [], []
    for i, (tile, ring) in enumerate(VARIANTS):
        cu = work / f"nco_{i}.cu"
        cu.write_text(variant_source(src, tile, ring))
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

    rows, n = CELL
    gains = pll_design(n, 19e3, 50.0)
    # Raw pilots as the cell's bandpass gives them: 19 kHz within +-3 Hz,
    # amplitude 0.1, noise at a tenth of it.
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(n, **f64) / n
    f = 19e3 + 6.0 * (torch.rand(rows, 1, generator=gen, **f64) - 0.5)
    phi = 2 * math.pi * torch.rand(rows, 1, generator=gen, **f64)
    x = (0.1 * math.sqrt(2.0) * torch.sin(2 * math.pi * f * t + phi)
         + 0.01 * torch.randn(rows, n, generator=gen, **f64)).float()
    scale = torch.reciprocal(torch.sqrt(torch.mean(x * x, -1)))
    zeros = torch.zeros(rows, device=device)
    shipped = knco.nco_pll_subcarrier_rows(x, scale, *gains, zeros, zeros)[0]
    _, lanes = knco.nco_geometry(
        rows, torch.cuda.get_device_properties(device).multi_processor_count)
    for _ in range(50):    # the clocks up before the first timing
        knco.nco_pll_subcarrier_rows(x, scale, *gains, zeros, zeros)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    probe = []
    for chain in knco.PROBE_CHAINS:
        _, cycles = knco.nco_chain_probe(n, chain, 1, *gains)
        links = n - n % knco.PHASOR_TILE if chain != "phasor" else n
        probe.append(f"{chain} {float(cycles.double().max()) / links:.1f}")
    print(f"[nco_sweep] chain probe, cycles a link over {n} links, one "
          f"lane: " + ", ".join(probe), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # The built libraries stay on disk until every variant has run.
    work = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    try:
        fns = build_variants(work)
        sub = torch.empty(CELL, device=device)
        state = torch.empty(2, rows, device=device)
        counts = torch.zeros(2, dtype=torch.int64, device=device)
        args = (x.data_ptr(), x.stride(0), scale.data_ptr(),
                zeros.data_ptr(), zeros.data_ptr(), sub.data_ptr(),
                state[0].data_ptr(), state[1].data_ptr(),
                counts[0].data_ptr(), counts[1].data_ptr(), rows, n, lanes,
                *knco.phasor_constants(*gains),
                knco.OUTPUTS.index("subcarrier"))
        for (tile, ring), fn in zip(VARIANTS, fns):
            def run(fn=fn):
                build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                            "rc_nco_pll")
            counts.zero_()
            ms = event_ms(run)
            same = bool(torch.equal(sub, shipped))
            print(f"[nco_sweep] tile {tile}, ring {ring}: {rows}x{n} "
                  f"{ms:.3f} ms ({ms * 1e3 * mhz / n:.1f} cycles a sample), "
                  f"starved {int(counts[1])} over 6 calls, equal to the "
                  f"shipped kernel: {same}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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

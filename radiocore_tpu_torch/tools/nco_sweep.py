"""K-NCO's design space on one NVIDIA GPU: its time over the tile length,
the L2 prefetch distance and the rows a block, for the phase form and the
phasor form.

Run from the root of a checkout: ``python3 -m
radiocore_tpu_torch.tools.nco_sweep``. It writes variants of
``csrc/nco_pll.cu`` with ``kNcoTile``, ``kNcoAhead`` (0: no prefetch) and
the rows a block (None: the kernel's own rule, ``nco_lanes``) replaced,
builds them with ``nvcc`` (the flags of ``kernels/build.py``, all at once)
into a temporary directory under ``_build``, and prints for each its time
(CUDA events, median of 5) and cycles a sample at 64 x 262 144, at
64 x 262 143 with every row off a 16-byte boundary and at 2048 x 8192, and
whether its trajectory equals the shipped kernel's bit for bit, with the
phasor form's time at 24 x 240 000 (the ``wbfm24_pll`` cell's shape)
beside it; then the phasor form alone at each of ``PHASOR_TILES`` samples
a tile, against the shipped phasor's subcarrier. The first variant of
each list is the shipped one. Before the variants it prints the cycles a
link of each chain of the shipped probe (``kernels/nco_pll.PROBE_CHAINS``)
over 240 000 links, one lane.

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
CELL = (24, 240_000)   # the wbfm24_pll cell's rows and samples a chunk
SEED = 1234

# (samples a tile, tiles between prefetch and use, rows a block).
VARIANTS = ((48, 8, None), (16, 0, 32), (16, 8, 32), (16, 8, None),
            (32, 8, None), (64, 8, None), (48, 0, None), (48, 8, 32))
# Samples a tile of the phasor form, the shipped one first.
PHASOR_TILES = (80, 48, 64, 72, 88, 96)


def variant_source(src: str, tile: int, ahead: int,
                   lanes: Optional[int],
                   phasor_tile: Optional[int] = None) -> str:
    """``csrc/nco_pll.cu`` with the tile, the prefetch distance (0: a
    distance no row reaches), the rows a block and the phasor form's tile
    replaced (None: as shipped); raises if the source no longer holds one
    of them."""
    subs = [(r"constexpr int kNcoTile = \d+;",
             f"constexpr int kNcoTile = {tile};"),
            (r"constexpr int kNcoAhead = \d+;",
             f"constexpr int kNcoAhead = {ahead if ahead else '1 << 30'};")]
    if lanes is not None:
        subs.append((re.escape("rc::nco_lanes(rows, sms)"), str(lanes)))
    if phasor_tile is not None:
        subs.append((r"constexpr int kNcoPhasorTile = \d+;",
                     f"constexpr int kNcoPhasorTile = {phasor_tile};"))
    for pattern, repl in subs:
        src, count = re.subn(pattern, repl, src)
        if count != 1:
            raise RuntimeError(f"nco_sweep: {pattern!r} found {count} times "
                               f"in csrc/nco_pll.cu")
    return src


def build_variants(work: Path):
    """Build every variant (:data:`VARIANTS`, then the shipped source at
    each of :data:`PHASOR_TILES`) into ``work``; for each in order, its
    phase form's and its phasor form's entry points."""
    from radiocore_tpu_torch.kernels import build
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    nvcc = build.find_nvcc()
    sources = [variant_source(src, *v) for v in VARIANTS]
    sources += [variant_source(src, *VARIANTS[0], phasor_tile=t)
                for t in PHASOR_TILES]
    cmds, libs = [], []
    for i, text in enumerate(sources):
        cu = work / f"nco_{i}.cu"
        cu.write_text(text)
        libs.append(work / f"libnco_{i}.so")
        cmds.append([nvcc, *build.COMPILE_FLAGS, "-shared", "-o",
                     str(libs[-1]), str(cu)])
    build._run_all(cmds)
    out = []
    for path in libs:
        lib = ctypes.CDLL(str(path))
        fns = []
        for name in ("rc_nco_pll", "rc_nco_pll_subcarrier"):
            fn = getattr(lib, name)
            fn.argtypes = build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns.append(fn)
        out.append(tuple(fns))
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
    # The cell's shape: raw pilots at a tenth of the normalised level.
    cell_gains = pll_design(CELL[1], 19e3, 50.0)
    cell = 0.1 * x[:CELL[0], :CELL[1]].contiguous()
    cell_scale = torch.reciprocal(torch.sqrt(torch.mean(cell * cell, -1)))
    cell_zeros = torch.zeros(CELL[0], device=device)
    cell_sub = knco.nco_pll_subcarrier_rows(cell, cell_scale, *cell_gains,
                                            cell_zeros, cell_zeros)[0]
    counter = knco.redone.tensor(device)
    for _ in range(50):    # the clocks up before the first timing
        knco.nco_pll_track_rows(cases["64x262144"], *gains,
                                zeros["64x262144"], zeros["64x262144"])
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    probe = []
    for chain in knco.PROBE_CHAINS:
        _, cycles = knco.nco_chain_probe(CELL[1], chain, 1, *cell_gains)
        tile = {"sample": knco.TILE,
                "phasor_sample": knco.PHASOR_TILE}.get(chain)
        links = CELL[1] - CELL[1] % tile if tile else CELL[1]
        probe.append(f"{chain} {float(cycles.double().max()) / links:.1f}")
    print(f"[nco_sweep] chain probe, cycles a link over {CELL[1]} links, one "
          f"lane: " + ", ".join(probe), flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # The built libraries stay on disk until every variant has run.
    work = Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    try:
        fns = build_variants(work)
        sub = torch.empty(CELL, device=device)
        cell_state = torch.empty(2, CELL[0], device=device)
        args = (cell.data_ptr(), cell.stride(0), cell_scale.data_ptr(),
                cell_zeros.data_ptr(), cell_zeros.data_ptr(), sub.data_ptr(),
                cell_state[0].data_ptr(), cell_state[1].data_ptr(),
                counter.data_ptr(), *CELL,
                *knco.phasor_constants(*cell_gains))

        def phasor_line(fn_phasor):
            def run_phasor():
                build.check(fn_phasor(
                    *args, torch.cuda.current_stream().cuda_stream),
                    "rc_nco_pll_subcarrier")
            ms = event_ms(run_phasor)
            same = bool(torch.equal(sub, cell_sub))
            return (f"phasor {CELL[0]}x{CELL[1]} {ms:.3f} ms "
                    f"({ms * 1e3 * mhz / CELL[1]:.1f} cycles a sample), "
                    f"equal to the shipped phasor: {same}")

        for (tile, ahead, lanes), (fn, fn_phasor) in zip(VARIANTS, fns):
            line = []
            for what, v in cases.items():
                rows, n = v.shape
                traj = torch.empty(rows, n, device=device)
                state = torch.empty(2, rows, device=device)

                def run():
                    build.check(fn(v.data_ptr(), v.stride(0),
                                   zeros[what].data_ptr(),
                                   zeros[what].data_ptr(), traj.data_ptr(),
                                   state[0].data_ptr(), state[1].data_ptr(),
                                   rows, n, *gains,
                                   torch.cuda.current_stream().cuda_stream),
                                "rc_nco_pll")
                ms = event_ms(run)
                same = bool(torch.equal(traj, shipped[what]))
                line.append(f"{what} {ms:.3f} ms ({ms * 1e3 * mhz / n:.1f} "
                            f"cycles a sample), equal to the shipped kernel: "
                            f"{same}")
            line.append(phasor_line(fn_phasor))
            ahead_s = f"{ahead} tiles ahead" if ahead else "off"
            print(f"[nco_sweep] tile {tile}, prefetch {ahead_s}, rows a "
                  f"block {lanes or 'by nco_lanes'}: " + "; ".join(line),
                  flush=True)
        for tile, (_, fn_phasor) in zip(PHASOR_TILES, fns[len(VARIANTS):]):
            print(f"[nco_sweep] phasor tile {tile}: {phasor_line(fn_phasor)}",
                  flush=True)
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

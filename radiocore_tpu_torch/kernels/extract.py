"""K-EXTRACT: fused channel extraction (window + Nyquist fold + backward
DFT + roll flip), hand-written for Hopper.

Counterpart of ``radiocore_tpu/kernels/extract_pallas.py``. Station i's
m-bin run starts at spectrum bin ``(a0 + i·m) mod n``; the kernel
(``csrc/extract.cu``) is K-FFT's pass plan for m-point rows with the
window, fold and ``s_norm`` scale as the first pass's load prologue and
the ``(−1)^t`` flip as the last pass's store epilogue, so it reads the
runs in place and writes the station IQ once.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs
:func:`extract_rows_plain`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.kernels.fft_rows import (MAX_ROW, MIN_ROW, Pass,
                                                  LaunchCounter)

LOAD_STRIDED, LOAD_EXTRACT = 0, 1
STORE_STRIDED, STORE_FLIP = 0, 1

launches = LaunchCounter()


def extract_ok(n: int, m: int, c: int) -> bool:
    """Whether the fused kernel supports this uniform extraction plan."""
    return ((m & (m - 1)) == 0 and MIN_ROW <= m <= MAX_ROW
            and n % m == 0 and n // m >= 2 and c <= n // m)


def extract_passes(m: int, c: int) -> List[Tuple[Pass, int, int]]:
    """K-FFT's plan for ``c`` rows of ``m`` points, with the extraction
    load on the first pass and the flip store on the last. The first
    pass's input offsets are flat (c, m) station indices."""
    passes = fft_rows.plan(m, c)
    out = []
    for i, p in enumerate(passes):
        load = LOAD_EXTRACT if i == 0 else LOAD_STRIDED
        store = STORE_FLIP if i == len(passes) - 1 else STORE_STRIDED
        out.append((p, load, store))
    return out


def _window(m: int, n: int, s_norm: float) -> np.ndarray:
    """Closed-form hann in raw run coordinates, times ``s_norm``."""
    k = np.arange(m, dtype=np.float64)
    return 0.5 * s_norm * (1.0 + np.cos(2.0 * np.pi * (k - m // 2) / n))


def extract_rows_plain(spectrum: torch.Tensor, a0: int, c: int, m: int,
                       s_norm: float) -> torch.Tensor:
    """Plain version: slice the runs, window, fold, ``ifft·m``, flip."""
    n = int(spectrum.shape[-1])
    rolled = torch.roll(spectrum, -int(a0), dims=-1)
    rows = rolled[:c * m].reshape(c, m)
    nxt = rolled[(torch.arange(1, c + 1, device=spectrum.device) * m) % n]
    w = torch.from_numpy(_window(m, n, s_norm)).to(
        device=spectrum.device, dtype=spectrum.real.dtype)
    u = rows * w
    u[:, 0] += nxt * w[0]
    y = torch.fft.ifft(u, dim=-1, norm="forward")
    flip = torch.ones(m, dtype=w.dtype, device=w.device)
    flip[1::2] = -1.0
    return y * flip


def _extract_kernel(spectrum: torch.Tensor, a0: int, c: int, m: int,
                    s_norm: float) -> torch.Tensor:
    from radiocore_tpu_torch.kernels import build
    if spectrum.dtype != torch.complex64:
        raise TypeError(f"extract_rows: kernel takes complex64, "
                        f"got {spectrum.dtype}")
    if not spectrum.is_contiguous():
        raise ValueError("extract_rows: kernel takes a contiguous spectrum")
    n = int(spectrum.shape[-1])
    lib = build.library()
    y = torch.empty((c, m), dtype=torch.complex64, device=spectrum.device)
    bufs = {"x": spectrum, "y": y}
    passes = extract_passes(m, c)
    if len(passes) > 1:
        bufs["s"] = torch.empty_like(y)
    stream = torch.cuda.current_stream().cuda_stream
    for p, load, store in passes:
        err = lib.rc_extract_pass(
            bufs[p.src].data_ptr(), bufs[p.dst].data_ptr(), load, store,
            p.L, p.P, p.S, p.B0, p.B1, p.ib0, p.ib1, p.is_, p.ij, p.ob0,
            p.ob1, p.os, p.ok, p.tw_n, 1, n, m, int(a0), float(s_norm),
            stream)
        build.check(err, f"rc_extract_pass(L={p.L}, m={m})")
        launches.count += 1
    return y


def extract_rows(spectrum: torch.Tensor, a0: int, c: int, m: int,
                 s_norm: float) -> torch.Tensor:
    """Uniform-plan channel extraction: ``spectrum (n,) → (c, m)`` station
    IQ, matching ``make_extractor``'s uniform path with hann windowing.
    ``s_norm`` is the total scale (``1/(s_fac·m)``)."""
    if spectrum.dim() != 1:
        raise ValueError("extract_rows: 1-D spectrum only")
    n = int(spectrum.shape[-1])
    if not extract_ok(n, m, c):
        raise ValueError(f"extract_rows: unsupported plan n={n} m={m} c={c}")
    a0 = int(a0) % n
    if spectrum.is_cuda:
        return _extract_kernel(spectrum, a0, c, m, s_norm)
    if spectrum.device.type != "cpu":
        raise ValueError(f"extract_rows: no kernel for {spectrum.device}")
    return extract_rows_plain(spectrum, a0, c, m, s_norm)

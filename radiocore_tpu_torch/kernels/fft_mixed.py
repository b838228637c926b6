"""K-MIXED: one long FFT of ``n = a·b`` points (``a ≤ 128``, possibly not a
power of two; ``b`` a power of two), hand-written for Hopper.

Counterpart of ``fft_large_mixed_pallas`` / ``mixed_split`` in
``radiocore_tpu/kernels/fft_pallas.py``: the 96-station band, n = 24M =
96 · 2^18, is its case. The four-step form with ``j = b·j1 + j2`` and
``k = k1 + a·k2``: a column pass (``csrc/fft_mixed.cu``) takes the
a-point DFT over j1 for each j2 with the twiddle ``W_n^{k1·j2}`` fused
into its store, then K-FFT's passes (:func:`row_passes`) transform the a
rows of b points, the last one storing element k2 of row k1 straight at
``k1 + a·k2``, so no transpose pass exists. The column pass factors
``a = 2^p·q`` (q odd) into a Stockham chain of a q-point stage and
power-of-two stages inside one tile of columns, and reads its twiddles
from :func:`mixed_table`.

A CUDA tensor launches the kernels (or raises); a CPU tensor runs
:func:`fft_large_mixed_plain` (``torch.fft``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.kernels.fft_rows import (MAX_ROW, MIN_ROW, Pass,
                                                  LaunchCounter)
from radiocore_tpu_torch.runtime.graphs import device_cache

MAX_A = 128     # the column pass's longest DFT (csrc/fft_mixed.cu kMaxA)
MAX_B = 1 << 18

launches = LaunchCounter()


def mixed_split(n: int) -> Optional[Tuple[int, int]]:
    """``n = a·b`` with pow2 ``b`` in [MIN_ROW, 2^18] and 2 ≤ a ≤ 128,
    ``b`` as large as possible (the JAX package's ``mixed_split``), or
    None."""
    n = int(n)
    b = MAX_B
    while b >= MIN_ROW:
        if n % b == 0 and 2 <= n // b <= MAX_A:
            return n // b, b
        b >>= 1
    return None


@functools.lru_cache(maxsize=32)
def row_passes(a: int, b: int) -> Tuple[Pass, ...]:
    """K-FFT's passes for the a rows of b points the column pass leaves
    (row stride b), with the last pass storing element k2 of row k1 at
    ``k1 + a·k2``. In K-FFT's plan the row stride is the only output
    stride equal to b (every within-row stride is smaller), so the last
    pass's strides map ``b → 1`` and ``e → a·e``.

    The last pass then makes the row its sub-FFT index ``s`` (it has no
    twiddle, so the order of its sub-FFTs is free): a block holds P
    neighbouring rows and stores runs of P neighbouring outputs, where
    K-FFT's order would store single elements a apart."""
    passes = list(fft_rows.plan(b, a))
    last = passes[-1]
    assert last.tw_n == 0

    def out(stride: int) -> int:
        return 1 if stride == b else stride * a

    dims = [[last.B0, last.ib0, out(last.ob0)],
            [last.B1, last.ib1, out(last.ob1)],
            [last.S, last.is_, out(last.os)]]
    row = next(i for i, d in enumerate(dims) if d[2] == 1)
    dims[row], dims[2] = dims[2], dims[row]
    (B0, ib0, ob0), (B1, ib1, ob1), (S, is_, os) = dims
    passes[-1] = dataclasses.replace(
        last, B0=B0, ib0=ib0, ob0=ob0, B1=B1, ib1=ib1, ob1=ob1, S=S,
        is_=is_, os=os, P=fft_rows._group(last.L, S), ok=out(last.ok))
    return tuple(passes)


@device_cache(maxsize=16)
def mixed_table(a: int, b: int, sign: float, device: torch.device
                ) -> torch.Tensor:
    """The column pass's twiddles in complex64, one tensor: ``W_a^e =
    exp(sign·2πi·e/a)`` for e < a, then :func:`fft_rows.two_level_table`
    of n = a·b (``lo``, 2^12 entries, then ``hi``), so that
    ``W_n^r = hi[r >> 12]·lo[r & 4095]`` for the outer twiddle, r < n."""
    n = a * b
    wa = np.exp(sign * 2j * np.pi * np.arange(a, dtype=np.float64) / a)
    hi, lo = fft_rows.two_level_table(n, sign)
    table = np.concatenate([wa.astype(np.complex64), lo, hi])
    return torch.from_numpy(table).to(device)


def column_buffer(passes: Tuple[Pass, ...]) -> str:
    """Where the column pass writes: the output ``y`` when the rows'
    first pass reads it and does not write it (two-pass rows), else a
    scratch of its own, ``c``. The rows read it as their ``x``."""
    return "y" if len(passes) == 2 else "c"


def launch_column(x: torch.Tensor, out: torch.Tensor, sign: float, a: int,
                  b: int) -> None:
    """The column pass of one transform: ``x`` (a·b) → ``out`` (a·b), both
    contiguous complex64 on one CUDA device."""
    from radiocore_tpu_torch.kernels import build
    sgn = -1 if sign < 0 else 1
    table = mixed_table(a, b, float(sgn), x.device)
    err = build.library().rc_mixed_column(
        x.data_ptr(), out.data_ptr(), a, b, sgn, table.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_mixed_column(a={a}, b={b})")
    launches.count += 1


def launch_rows(bufs: dict, sign: float, a: int, b: int) -> None:
    """K-FFT's row passes of one transform over the named buffers
    (``x`` the column pass's output, ``y`` the result, scratch)."""
    fft_rows.launch_passes(row_passes(a, b), bufs, sign, launches,
                           f"mixed n={a * b}")


def mixed_buffers(y: torch.Tensor, a: int, b: int) -> dict:
    """The buffers of one transform writing ``y``: the column buffer
    (:func:`column_buffer`), aliased as the rows' ``x``, and scratch."""
    passes = row_passes(a, b)
    col = column_buffer(passes)
    bufs = {"y": y}
    for name in {col, *(q for p in passes for q in (p.src, p.dst))}:
        if name not in ("x", "y"):
            bufs[name] = torch.empty(a * b, dtype=torch.complex64,
                                     device=y.device)
    bufs["x"] = bufs[col]
    return bufs


def _mixed_kernel(x: torch.Tensor, sign: float, a: int, b: int
                  ) -> torch.Tensor:
    if x.dtype != torch.complex64:
        raise TypeError(f"fft_large_mixed: kernel takes complex64, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fft_large_mixed: kernel takes a contiguous tensor")
    n = a * b
    y = torch.empty_like(x)
    for xi, yi in zip(x.reshape(-1, n), y.reshape(-1, n)):
        bufs = mixed_buffers(yi, a, b)
        launch_column(xi, bufs["x"], sign, a, b)
        launch_rows(bufs, sign, a, b)
    return y


def fft_large_mixed_plain(x: torch.Tensor, sign: float = -1.0
                          ) -> torch.Tensor:
    """Plain version: unnormalized DFT along the last axis (torch.fft),
    either sign."""
    return fft_rows.fft_pow2_plain(x, sign)


def fft_large_mixed(x: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """Unnormalized DFT of size ``a·2^k`` along the last axis (any leading
    dims). ``sign=-1`` forward, ``+1`` backward."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    n = int(x.shape[-1])
    if n <= MAX_ROW and (n & (n - 1)) == 0:
        return fft_rows.fft_pow2(x, sign)
    split = mixed_split(n)
    if split is None:
        raise ValueError(f"fft_large_mixed: no a·pow2 split with a <= "
                         f"{MAX_A} for n={n}")
    if x.is_cuda:
        return _mixed_kernel(x, sign, *split)
    if x.device.type != "cpu":
        raise ValueError(f"fft_large_mixed: no kernel for device {x.device}")
    return fft_large_mixed_plain(x, sign)

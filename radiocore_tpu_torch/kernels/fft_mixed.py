"""K-MIXED: one long FFT of ``n = a·b`` points (``a ≤ 128``, possibly not a
power of two; ``b`` a power of two), hand-written for Hopper.

Counterpart of ``fft_large_mixed_pallas`` / ``mixed_split`` in
``radiocore_tpu/kernels/fft_pallas.py``: the 96-station band, n = 24M =
96 · 2^18, is its case. The four-step form with ``j = b·j1 + j2`` and
``k = k1 + a·k2``: a column pass (``csrc/fft_mixed.cu``) takes the
a-point DFT over j1 for each j2 with the twiddle ``W_n^{k1·j2}`` fused
into its store, then K-FFT's passes (:func:`row_passes`) transform the a
rows of b points, the last one storing element k2 of row k1 straight at
``k1 + a·k2``, so no transpose pass exists.

A CUDA tensor launches the kernels (or raises); a CPU tensor runs
:func:`fft_large_mixed_plain` (``torch.fft``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.kernels.fft_rows import (MAX_ROW, MIN_ROW, Pass,
                                                  LaunchCounter)

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


def column_buffer(passes: Tuple[Pass, ...]) -> str:
    """Where the column pass writes: the output ``y`` when the rows'
    first pass reads it and does not write it (two-pass rows), else a
    scratch of its own, ``c``. The rows read it as their ``x``."""
    return "y" if len(passes) == 2 else "c"


def _mixed_kernel(x: torch.Tensor, sign: float, a: int, b: int
                  ) -> torch.Tensor:
    from radiocore_tpu_torch.kernels import build
    if x.dtype != torch.complex64:
        raise TypeError(f"fft_large_mixed: kernel takes complex64, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fft_large_mixed: kernel takes a contiguous tensor")
    n = a * b
    passes = row_passes(a, b)
    col = column_buffer(passes)
    lib = build.library()
    y = torch.empty_like(x)
    scratch = {name: torch.empty(n, dtype=torch.complex64, device=x.device)
               for name in {col, *(q for p in passes for q in (p.src, p.dst))}
               if name not in ("x", "y")}
    stream = torch.cuda.current_stream().cuda_stream
    sgn = -1 if sign < 0 else 1
    for xi, yi in zip(x.reshape(-1, n), y.reshape(-1, n)):
        bufs = {"y": yi, **scratch}
        bufs["x"] = bufs[col]
        err = lib.rc_mixed_column(xi.data_ptr(), bufs[col].data_ptr(), a, b,
                                  sgn, stream)
        build.check(err, f"rc_mixed_column(a={a}, b={b})")
        launches.count += 1
        for p in passes:
            err = lib.rc_fft_pass(bufs[p.src].data_ptr(),
                                  bufs[p.dst].data_ptr(), p.L, p.P, p.S,
                                  p.B0, p.B1, p.ib0, p.ib1, p.is_, p.ij,
                                  p.ob0, p.ob1, p.os, p.ok, p.tw_n, sgn,
                                  stream)
            build.check(err, f"rc_fft_pass(L={p.L}, mixed n={n})")
            launches.count += 1
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

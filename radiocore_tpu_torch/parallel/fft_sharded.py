"""Distributed four-step FFT over a time-sharded band; counterpart of
``radiocore_tpu/parallel/fft_sharded.py``.

1. :func:`fft_sharded_auto`: gather the band, then one local FFT: the
   replicated result that XLA's partitioner gives the reference.
2. :func:`fft_sharded_fourstep`: the transpose algorithm. With the band
   as an (N1, N2) matrix sharded over N1, the length-N2 row FFTs and the
   twiddle are local and the length-N1 column FFT needs the matrix
   transposed: one all-to-all each way.
3. :func:`fft_sharded_blocks`: the six-step form, one more all-to-all,
   standard-order output in contiguous blocks per rank.

All return the standard DFT (``numpy.fft.fft``), laid out
``k = k1 + N1·k2``. Each function takes this rank's block of the band
(a contiguous ``n/D`` samples, as the reference shards it) and each
rank's local FFTs go through the port's ``ops/fft``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.parallel.collectives import (Axis, all_gather,
                                                      all_to_all)
from radiocore_tpu_torch.parallel.mesh import TIME, AxisName, RadioMesh
from radiocore_tpu_torch.runtime.routes import Routes


def fft_sharded_auto(x: torch.Tensor, mesh: RadioMesh,
                     routes: Optional[Routes] = None) -> torch.Tensor:
    """Band FFT of the blocks sharded over the ``time`` axis: all-gather,
    then one FFT of the whole band, the same on every rank."""
    parts = all_gather(x, mesh.axis(TIME))
    return _fft.fft(parts.reshape(-1), routes)


@functools.lru_cache(maxsize=8)
def _twiddle(n1: int, n2: int, shards: int, me: int,
             device: torch.device) -> torch.Tensor:
    """``W_N^{j·k1}`` for this rank's columns ``j = me·cols + c`` and every
    ``k1``, (cols, n1) complex64. The angle is formed from ``j·k1 mod N``
    in integers and evaluated in float64, then rounded once."""
    n = n1 * n2
    cols = n2 // shards
    j = torch.arange(me * cols, (me + 1) * cols, dtype=torch.int64,
                     device=device)
    k1 = torch.arange(n1, dtype=torch.int64, device=device)
    ang = (j[:, None] * k1[None, :] % n).to(torch.float64) * (-2 * np.pi / n)
    return torch.polar(torch.ones_like(ang), ang).to(torch.complex64)


def _fourstep_local(x_block: torch.Tensor, n1: int, n2: int,
                    axis: Axis, routes: Optional[Routes] = None
                    ) -> torch.Tensor:
    """Per-rank body: ``x_block`` is (n1/D, n2) rows (i-major) of the
    band; returns (n1/D, n2), ``Z[k1_local, k2]``.

    With ``n = i·N2 + j`` and ``k = k1 + N1·k2``:
    ``X[k1 + N1·k2] = Σ_j W_N^{j·k1} W_{N2}^{j·k2} (Σ_i x[i·N2+j] W_{N1}^{i·k1})``:
    column FFT over i, twiddle, row FFT over j.
    """
    shards = axis.size
    rows = n1 // shards
    cols = n2 // shards
    # (rows, n2) → (n1, cols): entry [q, r, c] = rank q's rows, our
    # column slab.
    z = all_to_all(x_block.reshape(rows, shards, cols), 1, 0, axis)
    z = z.reshape(n1, cols)                     # i = q·rows + r
    y = _fft.fft(z.transpose(0, 1).contiguous(),
                 routes)                        # (cols, n1): Y[j, k1]
    y = y * _twiddle(n1, n2, shards, axis.index, y.device)
    # Back so that j is local per k1 block: (cols, n1) → (rows, n2) with
    # k1 = me·rows + r, j = q·cols + c.
    y = all_to_all(y.reshape(cols, shards, rows), 1, 0, axis)
    y = y.reshape(n2, rows).transpose(0, 1).contiguous()
    return _fft.fft(y, routes)                  # Z[k1_local, k2]


def _fourstep_local_blocks(x_block: torch.Tensor, n1: int, n2: int,
                           axis: Axis, routes: Optional[Routes] = None
                           ) -> torch.Tensor:
    """Per-rank body: a contiguous sample block → the contiguous spectrum
    block ``X[d·n/D : (d+1)·n/D]`` (the six-step FFT's final transpose,
    one more all-to-all): no rank holds the whole band or spectrum."""
    z = _fourstep_local(x_block.reshape(-1, n2), n1, n2, axis, routes)
    shards = axis.size
    rows = n1 // shards
    cols2 = n2 // shards
    # Send k2 chunk q to rank q; receive every rank's k1 rows for our k2
    # chunk: [p, r, c] = Z[p·rows + r, me·cols2 + c].
    z3 = all_to_all(z.reshape(rows, shards, cols2), 1, 0, axis)
    zt = z3.reshape(n1, cols2)                  # [k1, c]
    # Flat local offset c·n1 + k1 ↔ global k = k1 + n1·(me·cols2 + c).
    return zt.transpose(0, 1).reshape(-1)


def split_for_shards(n: int, shards: int):
    """Pick ``n = n1·n2`` with both factors divisible by ``shards``,
    as balanced as the factorization allows; None when impossible."""
    if shards <= 0 or n % (shards * shards):
        return None
    rest = n // (shards * shards)
    a = int(np.sqrt(rest))
    while a >= 1:
        if rest % a == 0:
            return shards * a, shards * (rest // a)
        a -= 1
    return None


def fft_sharded_blocks(x: torch.Tensor, mesh: RadioMesh,
                       axis_name: AxisName = TIME,
                       routes: Optional[Routes] = None) -> torch.Tensor:
    """Distributed standard-order FFT: this rank's contiguous block of
    the band in, its contiguous block of the spectrum out."""
    axis = mesh.axis(axis_name)
    shards = axis.size
    n = x.shape[-1] * shards
    split = split_for_shards(n, shards)
    if split is None:
        raise ValueError(
            f"no n1·n2 = {n} split with both factors divisible by {shards}")
    return _fourstep_local_blocks(x, *split, axis, routes)


def fft_sharded_fourstep(x: torch.Tensor, mesh: RadioMesh, n1: int,
                         axis_name: AxisName = TIME,
                         routes: Optional[Routes] = None) -> torch.Tensor:
    """Explicit distributed FFT: this rank's block of the band (rows of
    the (n1, n2) matrix) in, its rows of X in (k1, k2) matrix layout out;
    the whole matrix flattens to standard order as ``X.T.reshape(-1)``
    (``k = k1 + n1·k2``)."""
    axis = mesh.axis(axis_name)
    shards = axis.size
    n = x.shape[-1] * shards
    if n % n1:
        raise ValueError(f"n1 ({n1}) must divide n ({n})")
    n2 = n // n1
    if n1 % shards or n2 % shards:
        raise ValueError("n1 and n2 must divide by the shard count")
    return _fourstep_local(x.reshape(n1 // shards, n2), n1, n2, axis,
                           routes)

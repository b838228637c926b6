"""K-BANDFFT: one FFT of ``n = a·b`` points, ``a`` and ``b`` sides whose
chains the kernels are built for (:data:`CHAINS`), in two passes over
device memory, hand-written for Hopper.

The 10 MS/s band (n = 10^7 = 2^7·5^7) is its case: cuFFT takes it in three
passes (625·128·125), each reading and writing the 80 MB band; both sides
of ``10^7 = 3200·3125`` fit on chip, so the four-step form needs one
column pass and one row pass. With K-MIXED's index convention
(``kernels/fft_mixed.py``), ``j = b·j1 + j2`` and ``k = k1 + a·k2``: the
column pass (``csrc/fft_band.cu``, ``band_pass_kernel<false>``) takes the
a-point DFT of 4 neighbouring columns a unit, times the outer twiddle
``W_n^{k1·j2}``, into a scratch laid out as the row pass reads it
(:func:`scratch_index`); the row pass (``band_pass_kernel<true>``) takes
the b-point DFT of 4 neighbouring rows a unit and stores element k2 of
row k1 at ``k1 + a·k2``: natural order, no transpose. A sequence's DFT is
an in-place chain of the radices of :data:`CHAINS` over points put at
their :func:`digit_reversal` places, twiddled from
:func:`band_table` (float64, rounded once).

Replaces no TPU kernel: the reference sends this size to XLA's FFT. A CUDA
tensor launches the kernels (or raises); a CPU tensor runs
:func:`fft_band_plain` (``torch.fft``). :func:`band_model` is the two
passes in NumPy, in the kernels' order, for the CPU tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels.fft_rows import LaunchCounter
from radiocore_tpu_torch.runtime.graphs import device_cache

# The geometry of csrc/fft_band.cu (kBandW, kBandT, kBandMaxL, kBandUBits,
# kBandGroups).
SEQUENCES = 4           # sequences a unit: 32-byte runs on the strided side
THREADS = 128           # threads a sequence
# Two tiles of 4 sequences in shared memory (the next unit's loads while a
# block transforms the current one) and the pass's stage twiddles:
# (2·4·3200 + 3199) complex64 is 230 392 B of the 232 448 a block may have.
MAX_SIDE = 3200
U_BITS = 5              # outer twiddle: j2 = 32·(j2 >> 5) + (j2 & 31)
# The sides the kernels are built for, each with its chain of radices (odd
# radices first: the first stage's butterflies take points R apart, which
# for an odd R fall in distinct banks), every offset and bound a constant
# in csrc/fft_band.cu; a chain read from a plan at run time spilled.
CHAINS = {3200: (25, 16, 8), 3125: (25, 25, 5)}

launches = LaunchCounter()


def band_split(n: int) -> Optional[Tuple[int, int]]:
    """``n = a·b`` for K-BANDFFT, or None: a and b sides of
    :data:`CHAINS`, a a multiple of 4 (the row pass then stores each row
    group's 4 neighbouring points as one whole 32-byte sector; with
    a = 3125 it took twice as long). A rule on n only: 10^7 gives
    3200 × 3125, and 3200 × 3200 is the only other size."""
    n = int(n)
    for a in CHAINS:
        if a % SEQUENCES == 0 and n % a == 0 and n // a in CHAINS:
            return a, n // a
    return None


def groups(L: int) -> int:
    """Units of 4 sequences over L of them, the last one ragged: row
    groups of a, tiles of b's columns."""
    return -(-L // SEQUENCES)


GROUPS = 8              # row groups a block of the scratch holds


def scratch_points(a: int, b: int) -> int:
    """Points of one transform in the scratch: blocks of :data:`GROUPS`
    row groups (``ceil(a/4)`` of them), each ``GROUPS·16·ceil(b/4)``
    points (:func:`scratch_index`)."""
    return -(-groups(a) // GROUPS) * GROUPS * 16 * groups(b)


def scratch_index(k1, j2, a: int, b: int):
    """Where the column pass stores ``T[k1, j2]``: block of GROUPS row
    groups ``k1 >> 5``, tile of columns ``j2 >> 2`` (``16·GROUPS``
    points), row group ``(k1 >> 2) mod GROUPS`` (16 points), column ``j2 &
    3``, row ``k1 & 3``: a column unit writes runs of 1 KB, and a row unit
    reads 128-byte runs, between which the units beside it read."""
    return ((k1 >> 5) * GROUPS * 16 * groups(b) + (j2 >> 2) * 16 * GROUPS
            + ((k1 >> 2) % GROUPS) * 16 + (j2 & 3) * 4 + (k1 & 3))


def _stage_twiddles(L: int, radices) -> np.ndarray:
    """A pass's stage twiddles in float64, as the kernel reads them:
    stage by stage, ``W_{Ns·R}^{q·bm}`` at ``(q − 1)·Ns + bm`` (q < R,
    bm < Ns), forward sign; L − 1 entries in all."""
    parts, ns = [], 1
    for r in radices:
        q = np.arange(1, r)[:, None]
        bm = np.arange(ns)[None, :]
        parts.append(np.exp(-2j * np.pi * (q * bm) / (ns * r)).ravel())
        ns *= r
    return np.concatenate(parts)


def table_offsets(a: int, b: int) -> dict:
    """Offsets of :func:`band_table`'s parts, as ``rc_fft_band`` computes
    them: the column pass's stage twiddles, the row pass's, U, V."""
    u = (a - 1) + (b - 1)
    return {"col": 0, "row": a - 1, "u": u,
            "v": u + -(-b // (1 << U_BITS)) * a}


def digit_reversal(L: int, radices) -> np.ndarray:
    """Where the loads put point j of a sequence: the chain's last stage
    (radix R) combines the R transforms of points ``j ≡ r (mod R)``, each
    ``L/R`` points long at ``r·L/R``, and so on down the chain; the first
    stage's place of a point is its own. The in-place stages then leave
    the transform in natural order."""
    radices = tuple(radices)
    if len(radices) <= 1:
        return np.arange(L, dtype=np.int64)
    r = radices[-1]
    sub = digit_reversal(L // r, radices[:-1])
    j = np.arange(L, dtype=np.int64)
    return (j % r) * (L // r) + sub[j // r]


def table_np(col, row) -> np.ndarray:
    """:func:`band_table` in NumPy (complex64), for the passes' chains
    ``col`` and ``row`` (a and b their products)."""
    a, b = int(np.prod(col)), int(np.prod(row))
    n = a * b
    k1 = np.arange(a, dtype=np.int64)[None, :]
    uj = np.arange(-(-b // (1 << U_BITS)), dtype=np.int64)[:, None]
    vj = np.arange(1 << U_BITS, dtype=np.int64)[:, None]
    u = np.exp(-2j * np.pi * (((uj << U_BITS) * k1) % n) / n)
    v = np.exp(-2j * np.pi * ((vj * k1) % n) / n)
    return np.concatenate([_stage_twiddles(a, col), _stage_twiddles(b, row),
                           u.ravel(), v.ravel()]).astype(np.complex64)


@device_cache(maxsize=8)
def band_table(a: int, b: int, device: torch.device) -> torch.Tensor:
    """Every twiddle of one split, forward sign, complex64, one tensor
    (:func:`table_offsets`): the two passes' stage twiddles, then the
    outer twiddle's ``U[uj][k1] = W_n^{32·uj·k1}`` and ``V[vj][k1] =
    W_n^{vj·k1}``, so that ``W_n^{k1·j2} = U[j2 >> 5][k1]·V[j2 & 31][k1]``;
    each from a float64 phase reduced on integers, rounded once."""
    return torch.from_numpy(table_np(CHAINS[a], CHAINS[b])).to(device)


def first_points(L: int, radices) -> np.ndarray:
    """For each butterfly bf of the first stage, the point j0 whose
    :func:`digit_reversal` place is ``bf·R``: the butterfly takes points
    ``j0 + q·L/R`` of the sequence as loaded (natural order) and writes
    its outputs to ``bf·R + q``, where the in-place chain goes on."""
    rev = digit_reversal(L, radices)
    inv = np.empty(L, dtype=np.int64)
    inv[rev] = np.arange(L)
    r = radices[0]
    return inv[np.arange(L // r) * r]


@device_cache(maxsize=8)
def band_first(a: int, b: int, device: torch.device) -> torch.Tensor:
    """:func:`first_points` of a and of b in int32, one tensor, as
    ``rc_fft_band`` reads it."""
    first = np.concatenate([first_points(a, CHAINS[a]),
                            first_points(b, CHAINS[b])])
    return torch.from_numpy(first.astype(np.int32)).to(device)


def launch(x: torch.Tensor, scratch: torch.Tensor, y: torch.Tensor,
           sign: float, a: int, b: int) -> None:
    """The kernels' two passes over the rows of ``x`` (contiguous
    complex64, (batch, a·b)) into ``y`` through ``scratch``
    (:func:`scratch_points` a row)."""
    from radiocore_tpu_torch.kernels import build
    batch = x.numel() // (a * b)
    err = build.library().rc_fft_band(
        x.data_ptr(), scratch.data_ptr(), y.data_ptr(), batch, a, b,
        -1 if sign < 0 else 1, band_table(a, b, x.device).data_ptr(),
        band_first(a, b, x.device).data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_fft_band(batch={batch}, a={a}, b={b})")
    launches.count += 2


def fft_band_rows(x: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """The kernels along the last axis of a contiguous complex64 CUDA
    tensor whose length has a :func:`band_split`, any leading dims;
    unnormalized, ``sign`` −1 forward, +1 backward. Raises on what they do
    not take, before any launch; ``x`` is never written."""
    if x.dtype != torch.complex64:
        raise TypeError(f"fft_band_rows: kernel takes complex64, got "
                        f"{x.dtype}")
    n = int(x.shape[-1]) if x.dim() else 0
    split = band_split(n) if n else None
    if split is None or x.numel() == 0:
        raise ValueError(f"fft_band_rows: no band split for a last axis of "
                         f"{n} points (shape {tuple(x.shape)})")
    if not x.is_contiguous():
        raise ValueError("fft_band_rows: kernel takes a contiguous tensor")
    if x.is_conj():
        raise ValueError("fft_band_rows: a lazy conj view (resolve it "
                         "first: the kernel reads the stored values)")
    if not x.is_cuda:
        raise ValueError(f"fft_band_rows: kernel takes a CUDA tensor, got "
                         f"one on {x.device}")
    a, b = split
    batch = x.numel() // n
    y = torch.empty_like(x)
    scratch = torch.empty(batch * scratch_points(a, b), dtype=x.dtype,
                          device=x.device)
    launch(x, scratch, y, sign, a, b)
    return y


def fft_band_plain(x: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """Plain version: unnormalized DFT along the last axis (torch.fft),
    either sign."""
    if sign < 0:
        return torch.fft.fft(x, dim=-1)
    return torch.fft.ifft(x, dim=-1, norm="forward")


def fft_band(x: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """Unnormalized DFT of a size with a :func:`band_split` along the last
    axis: the kernels on a CUDA tensor, :func:`fft_band_plain` on a CPU
    one."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    if x.is_cuda:
        return fft_band_rows(x, sign)
    if x.device.type != "cpu":
        raise ValueError(f"fft_band: no kernel for device {x.device}")
    return fft_band_plain(x, sign)


# ---- the two passes in NumPy ------------------------------------------

def _chain(X: np.ndarray, radices, tw: np.ndarray) -> np.ndarray:
    """The kernels' chain along axis 0 of ``X`` (L, m): the first stage's
    butterfly bf reads points ``j0 + q·L/R`` (:func:`first_points`) and
    writes its outputs to ``bf·R + q``; then stage by stage, in place,
    butterfly ``bf`` (``bm = bf mod Ns``) reads points ``base + q·Ns``,
    ``base = (bf − bm)·R + bm``, twiddled by ``tw`` at ``(q − 1)·Ns +
    bm``, and writes its outputs back there."""
    L = X.shape[0]
    ns, at = 1, 0
    for s, r in enumerate(radices):
        bf = np.arange(L // r)
        bm = bf % ns
        q = np.arange(r)[:, None]
        dft = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        if s == 0:
            j0 = first_points(L, radices)
            Y = np.empty_like(X)
            Y[(bf * r)[None, :] + q] = np.tensordot(
                dft, X[j0[None, :] + q * (L // r)], axes=(1, 0))
        else:
            where = ((bf - bm) * r + bm)[None, :] + q * ns   # (r, nb)
            w = np.ones(where.shape, dtype=np.complex128)
            w[1:] = tw[at + (q[1:] - 1) * ns + bm[None, :]]
            Y[where] = np.tensordot(dft, Y[where] * w[:, :, None],
                                    axes=(1, 0))
        at += (r - 1) * ns
        ns *= r
    return Y


def band_model(x: np.ndarray, sign: float = -1.0, block: int = 1 << 21,
               chains=None) -> np.ndarray:
    """The kernels' two passes in NumPy (complex128 arithmetic on the
    complex64 tables), along the last axis: the column pass over column
    tiles, each column's chain, the outer twiddle from U and V, the store
    at :func:`scratch_index`; the row pass reading each row back from
    there, its chain, and the store of element k2 of row k1 at
    ``k1 + a·k2``; the backward sign by conjugating in and out. ``block``
    bounds the points transformed at once. ``chains``: the passes' radices,
    those of :func:`band_split`'s sides by default; any other pair runs
    the same order at the size it multiplies to."""
    x = np.asarray(x)
    n = x.shape[-1]
    if chains is None:
        a, b = band_split(n)
        chains = (CHAINS[a], CHAINS[b])
    col_chain, row_chain = chains
    a, b = int(np.prod(col_chain)), int(np.prod(row_chain))
    if a * b != n:
        raise ValueError(f"band_model: chains of {a} · {b} points for a "
                         f"last axis of {n}")
    tab = table_np(col_chain, row_chain).astype(np.complex128)
    off = table_offsets(a, b)
    u = tab[off["u"]:off["v"]].reshape(-1, a)
    v = tab[off["v"]:].reshape(1 << U_BITS, a)
    col_tw, row_tw = tab[off["col"]:off["row"]], tab[off["row"]:off["u"]]
    rows = x.reshape(-1, n)
    out = np.empty(rows.shape, dtype=np.complex128)
    k1 = np.arange(a)[:, None]
    step = max(SEQUENCES, (block // a) // SEQUENCES * SEQUENCES)
    for i, row in enumerate(rows):
        cols = row.reshape(a, b)
        scratch = np.zeros(scratch_points(a, b), dtype=np.complex128)
        for j0 in range(0, b, step):
            j2 = np.arange(j0, min(b, j0 + step))[None, :]
            t = cols[:, j0:j0 + step].astype(np.complex128)
            if sign > 0:
                t = np.conj(t)
            t = _chain(t, col_chain, col_tw)
            t *= u[j2 >> U_BITS, k1] * v[j2 & ((1 << U_BITS) - 1), k1]
            scratch[scratch_index(k1, j2, a, b)] = t
            del t
        rstep = max(1, block // b)
        j2 = np.arange(b)[:, None]
        for r0 in range(0, a, rstep):
            kk = np.arange(r0, min(a, r0 + rstep))[None, :]
            y = _chain(scratch[scratch_index(kk, j2, a, b)], row_chain,
                       row_tw)                                  # (k2, rows)
            out[i][kk + a * np.arange(b)[:, None]] = (
                np.conj(y) if sign > 0 else y)
        del scratch
    return out.reshape(x.shape)

"""K-FFT: batched power-of-two FFT of rows, hand-written for Hopper.

Counterpart of ``radiocore_tpu/kernels/fft_pallas.py``. The kernel
(``csrc/fft_rows.cu`` over ``csrc/fft_common.cuh``) computes a batch of
sub-FFTs of at most :data:`SUB_MAX` points per pass; :func:`plan` chains
passes into the four-step form (two passes up to ``SUB_MAX**2`` points,
three above), with the twiddle fused into the first pass's store and the
last pass storing in natural order. :func:`rfft_pow2` and
:func:`irfft_pow2` add one elementwise kernel each (untangle, tangle).

Every public function takes its tensor's device as the route: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
PyTorch version beside it (``torch.fft``), which the CPU tests and the
on-card comparison use.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch

MIN_ROW = 256
MAX_ROW = 1 << 19
SUB_MAX = 4096          # longest sub-FFT of one pass (32 KB of complex64)
# Points per block, P sub-FFTs of length L (the kernel takes up to 16384):
# 8192 points are 512 threads and 70 KB of shared memory, so two blocks
# are resident per SM and one block's loads overlap another's butterflies.
BLOCK_POINTS = 8192
# 512-point sub-FFTs take blocks of 8 (256 threads, three blocks per SM):
# the kernel built for that length then has 80 registers a thread and does
# not spill (csrc/fft_common.cuh kFastLg, kFastThreads).
FAST_SUB = 512
FAST_BLOCK_POINTS = 4096
KERNEL_BLOCK_POINTS = 16384   # csrc/fft_common.cuh kBlockPoints
POINTS_PER_THREAD = 16        # csrc/fft_common.cuh kVals
MIN_GROUP = 4           # sub-FFTs per block at least: 32-byte strided runs
TWIDDLE_BITS = 12       # two-level twiddle tables of 2^12 entries

COUNTERS: List["LaunchCounter"] = []


class LaunchCounter:
    """Number of kernel launches since the last :meth:`reset`. Every
    counter registers itself in :data:`COUNTERS`, where a compiled step
    (``runtime/graphs``) reads what its capture counted, to add it again
    at every replay."""

    def __init__(self) -> None:
        self.count = 0
        COUNTERS.append(self)

    def reset(self) -> None:
        self.count = 0


launches = LaunchCounter()
# The same launches by the entry that made them: ``fft_pow2`` and
# ``ifft_pow2`` (rows of at most MAX_ROW, forward and backward, whichever
# wrapper or route asked), ``rfft_pow2``, ``irfft_pow2`` (each with its
# untangle or tangle) and ``fft_large_pow2`` (longer rows).
entry_launches = {name: LaunchCounter() for name in (
    "fft_pow2", "ifft_pow2", "rfft_pow2", "irfft_pow2", "fft_large_pow2")}


def _row_entry(n: int, sign: float) -> str:
    if n > MAX_ROW:
        return "fft_large_pow2"
    return "fft_pow2" if sign < 0 else "ifft_pow2"


def _count(entry: str, made: int) -> None:
    launches.count += made
    entry_launches[entry].count += made


@dataclasses.dataclass(frozen=True)
class Pass:
    """One kernel launch: sub-FFT (b0, b1, s) reads element j at
    ``b0*ib0 + b1*ib1 + s*is_ + j*ij`` of ``src`` and writes element k at
    ``b0*ob0 + b1*ob1 + s*os + k*ok`` of ``dst``, times the twiddle
    ``exp(sign*2πi*s*k/tw_n)`` when ``tw_n``; with ``keep``, only the
    elements ``s*os + k*ok < keep`` are written."""
    L: int
    P: int
    S: int
    B0: int
    B1: int
    ib0: int
    ib1: int
    is_: int
    ij: int
    ob0: int
    ob1: int
    os: int
    ok: int
    tw_n: int
    src: str    # "x" (input), "y" (output) or "s" (scratch)
    dst: str
    keep: int = 0


PASS_FIELDS = 15        # csrc/fft_common.cuh kPassFields


def pass_records(passes) -> ctypes.Array:
    """The passes as the flat ``long long`` records the C schedule entry
    points read (``csrc/fft_common.cuh`` ``pass_from_record``): L, P, S,
    B0, B1, ib0, ib1, is, ij, ob0, ob1, os, ok, tw_n, keep per pass."""
    flat = [v for p in passes for v in (
        p.L, p.P, p.S, p.B0, p.B1, p.ib0, p.ib1, p.is_, p.ij, p.ob0, p.ob1,
        p.os, p.ok, p.tw_n, p.keep)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def _split(n: int) -> Tuple[int, int]:
    """``n = n1·n2``, n1 ≤ SUB_MAX, as balanced as that allows."""
    lg = n.bit_length() - 1
    n1 = 1 << min((lg + 1) // 2, SUB_MAX.bit_length() - 1)
    return n1, n // n1


def _group(L: int, S: int) -> int:
    """Sub-FFTs per block: fill BLOCK_POINTS, but at least MIN_GROUP (a
    strided side then moves whole 32-byte sectors) within the kernel's
    block; at most next_pow2(S)."""
    points = min(FAST_BLOCK_POINTS, BLOCK_POINTS) if L == FAST_SUB \
        else BLOCK_POINTS
    p = max(points // L, min(MIN_GROUP, KERNEL_BLOCK_POINTS // L), 1)
    return min(p, 1 << max(S - 1, 0).bit_length())


@functools.lru_cache(maxsize=64)
def plan(n: int, batch: int) -> Tuple[Pass, ...]:
    """Passes for ``batch`` contiguous rows of ``n`` points (pow2 ≥ 2)."""
    if not _is_pow2(n) or n < 2:
        raise ValueError(f"fft plan: n={n} is not a power of two >= 2")
    if n <= SUB_MAX:
        # One pass; the rows are the sub-FFT index s.
        return (Pass(n, _group(n, batch), batch, 1, 1, 0, 0, n, 1,
                     0, 0, n, 1, 0, "x", "y"),)
    n1, n2 = _split(n)
    # j = n2·j1 + j2, k = k1 + n1·k2: pass 1 is the n1-point DFT over j1
    # for each j2 (= s), twiddled by W_n^{j2·k1} and stored at k1·n2 + j2.
    first = Pass(n1, _group(n1, n2), n2, 1, batch, 0, n, 1, n2,
                 0, n, 1, n2, n, "x", "y" if n2 > SUB_MAX else "s")
    if n2 <= SUB_MAX:
        # Pass 2: the n2-point DFT of each row k1 (= s), stored at
        # k1 + n1·k2 (natural order).
        return (first, Pass(n2, _group(n2, n1), n1, 1, batch, 0, n, n2, 1,
                            0, n, 1, n1, 0, "s", "y"))
    # n2 = n21·n22 > SUB_MAX: the rows of pass 1's output are themselves
    # two-pass transforms, batched over (row, k1), whose last pass stores
    # straight to k1 + n1·(k2a + n21·k2b).
    n21, n22 = _split(n2)
    if n22 > SUB_MAX:
        raise ValueError(f"fft plan: n={n} needs more than three passes")
    second = Pass(n21, _group(n21, n22), n22, batch, n1, n, n2, 1, n22,
                  n, n2, 1, n22, n2, "y", "s")
    third = Pass(n22, _group(n22, n21), n21, batch, n1, n, n2, n22, 1,
                 n, 1, n1, n1 * n21, 0, "s", "y")
    return (first, second, third)


def _fft_kernel(x: torch.Tensor, sign: float,
                entry: str = "") -> torch.Tensor:
    """Launch the pass plan on a contiguous complex64 CUDA tensor,
    counting its launches on :data:`launches` and on ``entry``'s counter
    (by default the row entry of its length and sign)."""
    if x.dtype != torch.complex64:
        raise TypeError(f"fft_rows: kernel takes complex64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fft_rows: kernel takes a contiguous tensor")
    n = int(x.shape[-1])
    passes = plan(n, x.numel() // n)
    y = torch.empty_like(x)
    bufs = {"x": x, "y": y}
    if any("s" in (p.src, p.dst) for p in passes):
        bufs["s"] = torch.empty_like(x)
    before = launches.count
    launch_passes(passes, bufs, sign, launches, f"n={n}")
    entry_launches[entry or _row_entry(n, sign)].count += (
        launches.count - before)
    return y


def launch_passes(passes: Tuple[Pass, ...], bufs: dict, sign: float,
                  counter: LaunchCounter, what: str) -> None:
    """Launch ``rc_fft_pass`` for each pass over the named CUDA buffers
    on the current stream, counting each launch on ``counter``."""
    from radiocore_tpu_torch.kernels import build
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    sgn = -1 if sign < 0 else 1
    for p in passes:
        err = lib.rc_fft_pass(bufs[p.src].data_ptr(), bufs[p.dst].data_ptr(),
                              p.L, p.P, p.S, p.B0, p.B1, p.ib0, p.ib1,
                              p.is_, p.ij, p.ob0, p.ob1, p.os, p.ok, p.tw_n,
                              sgn, stream)
        build.check(err, f"rc_fft_pass(L={p.L}, {what})")
        counter.count += 1


def fft_pow2_plain(x: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """Plain version: unnormalized DFT along the last axis (torch.fft)."""
    if sign < 0:
        return torch.fft.fft(x, dim=-1)
    return torch.fft.ifft(x, dim=-1, norm="forward")


def _route(x: torch.Tensor, sign: float) -> torch.Tensor:
    if x.is_cuda:
        return _fft_kernel(x, sign)
    if x.device.type != "cpu":
        raise ValueError(f"fft_rows: no kernel for device {x.device}")
    return fft_pow2_plain(x, sign)


def _as_complex(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_complex() else x.to(torch.complex64)


def _check_row(length: int) -> None:
    if not _is_pow2(length) or not (MIN_ROW <= length <= MAX_ROW):
        raise ValueError(f"fft_pow2: row length {length} unsupported "
                         f"(pow2 in [{MIN_ROW}, {MAX_ROW}])")


def fft_pow2(x: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """Unnormalized DFT along the last axis of pow2 rows in
    [MIN_ROW, MAX_ROW]; any leading batch dims. ``sign=-1`` forward,
    ``+1`` backward (the caller scales by 1/L)."""
    x = _as_complex(x)
    _check_row(int(x.shape[-1]))
    return _route(x, sign)


def fft_pow2_planar(xr: torch.Tensor, xi: torch.Tensor,
                    sign: float = -1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fft_pow2` on (real, imag) float32 planes."""
    y = fft_pow2(torch.complex(xr.float(), xi.float()), sign)
    return y.real, y.imag


def ifft_pow2(x: torch.Tensor) -> torch.Tensor:
    """Normalized inverse counterpart of :func:`fft_pow2`."""
    return fft_pow2(x, sign=+1.0) / x.shape[-1]


def two_level_table(n: int, sign: float, bits: int = TWIDDLE_BITS
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``(hi, lo)`` in complex64 with ``exp(sign·2πi·r/n) ≈
    hi[r >> bits] · lo[r & (2^bits − 1)]`` for ``0 ≤ r < n``: ``lo[e] =
    exp(sign·2πi·e/n)`` for ``e < 2^bits`` and ``hi[e] = exp(sign·2πi·
    (e·2^bits mod n)/n)`` for ``e < ceil(n / 2^bits)``, each from float64
    phases reduced on integers and rounded once. K-MIXED's outer twiddle
    reads it (``fft_mixed.mixed_table``), where n is not a power of two.
    The pass engine's four-step twiddle (n a power of two) is sincospif
    of an exact argument instead, which measured faster on the card."""
    size = 1 << bits
    lo = np.arange(size, dtype=np.int64) % n
    hi = (np.arange(-(-n // size), dtype=np.int64) * size) % n
    return tuple(np.exp(sign * 2j * np.pi * (e.astype(np.float64) / n)
                        ).astype(np.complex64) for e in (hi, lo))


def rfft_pow2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rfft_pow2` (torch.fft.rfft)."""
    return torch.fft.rfft(x, dim=-1)


def rfft_pow2(x: torch.Tensor) -> torch.Tensor:
    """Real-input FFT along the last axis → ``n//2 + 1`` bins.

    On CUDA: even/odd samples packed as one length-n/2 complex row (a
    free view of the float32 data), the kernel, then the untangle as one
    more kernel (``rc_rfft_untangle``): ``X[k] = A[k]·Z[k] +
    B[k]·conj(Z[h−k])`` for k = 0..h, ``Z[h] = Z[0]``,
    ``A = (1 − i·w)/2``, ``B = (1 + i·w)/2``, ``w = exp(−2πi·k/n)``.
    """
    n = int(x.shape[-1])
    h = n // 2
    _check_row(h)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"rfft_pow2: no kernel for device {x.device}")
        return rfft_pow2_plain(x)
    if x.dtype != torch.float32:
        raise TypeError(f"rfft_pow2: kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("rfft_pow2: kernel takes a contiguous tensor")
    from radiocore_tpu_torch.kernels import build
    z = _fft_kernel(torch.view_as_complex(x.view(x.shape[:-1] + (h, 2))),
                    -1.0, "rfft_pow2")
    out = torch.empty(x.shape[:-1] + (h + 1,), dtype=torch.complex64,
                      device=x.device)
    err = build.library().rc_rfft_untangle(
        z.data_ptr(), out.data_ptr(), z.numel() // h, h,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_rfft_untangle(n={n})")
    _count("rfft_pow2", 1)
    return out


def irfft_pow2(X: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`rfft_pow2` to real length ``n``; the imaginary
    parts of the DC and Nyquist bins are ignored (np.fft.irfft).

    On CUDA: the tangle as a kernel (``rc_irfft_tangle``), the length-h
    complex row whose unnormalized backward FFT holds ``irfft(X, n)`` as
    (even, odd) sample pairs, times 1/h; then the backward h-point kernel
    and the real view of its output."""
    n = int(n)
    h = n // 2
    _check_row(h)
    if X.shape[-1] != h + 1:
        raise ValueError(f"irfft_pow2: expected {h + 1} bins, "
                         f"got {X.shape[-1]}")
    if not X.is_cuda:
        if X.device.type != "cpu":
            raise ValueError(f"irfft_pow2: no kernel for device {X.device}")
        return torch.fft.irfft(X, n=n, dim=-1)
    from radiocore_tpu_torch.kernels import build
    if X.dtype != torch.complex64:
        raise TypeError(f"irfft_pow2: kernel takes complex64, got {X.dtype}")
    if not X.is_contiguous():
        raise ValueError("irfft_pow2: kernel takes a contiguous tensor")
    z = torch.empty(X.shape[:-1] + (h,), dtype=torch.complex64,
                    device=X.device)
    err = build.library().rc_irfft_tangle(
        X.data_ptr(), z.data_ptr(), z.numel() // h, h,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_irfft_tangle(n={n})")
    _count("irfft_pow2", 1)
    y = _fft_kernel(z, +1.0, "irfft_pow2")
    return torch.view_as_real(y).reshape(X.shape[:-1] + (n,))


def fft_large_pow2(x: torch.Tensor, sign: float = -1.0) -> torch.Tensor:
    """One long pow2 FFT (e.g. the 2^24 band) along the last axis.

    Rows up to MAX_ROW are :func:`fft_pow2`; longer ones use the same
    kernel's multi-pass plan (two passes up to 2^24, three above).
    """
    x = _as_complex(x)
    n = int(x.shape[-1])
    if not _is_pow2(n):
        raise ValueError(f"fft_large_pow2: n={n} not a power of 2")
    if n <= MAX_ROW:
        return fft_pow2(x, sign)
    return _route(x, sign)


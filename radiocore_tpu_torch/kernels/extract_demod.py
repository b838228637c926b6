"""K-XDEMOD and K-XDEMOD-SPEC: fused channel extraction + FM quadrature
demod (+ the composite spectrum), hand-written for Hopper.

Counterpart of ``radiocore_tpu/kernels/extract_demod_pallas.py``:
``extract_demod_rows`` is ``quadrature_demod(extract_rows(...))`` (gain
``1/π``, ``quad[:, 0] = 0``) without the station IQ ever reaching device
memory, and ``extract_demod_spec_rows`` is the forward DFT of that quad,
of which only the first ``keep_bins`` bins are written.

The plan (:func:`plan`, ``csrc/extract_demod.cu``) splits ``m = n1·n2``:
K-EXTRACT's first pass (extraction load, n1-point DFTs, twiddle), then
the demod pass — the n2-point DFT of each row ``s`` with the demod in its
epilogue, each block carrying one halo row so that ``x[t−1]`` is in
shared memory; every thread demodulates the 16 points it holds against
the row before it, and the quad leaves through a staged 16-byte store —
and, for SPEC, a keep pass that finishes the forward transform and
writes bins ``< keep`` only. The discriminator is the kernel's own
``atan2_fast`` (:func:`atan2_fast_model`): 0 at the origin, so a dead
station gives silence as in the JAX package. K-XDEMOD's passes run per
group of G stations over lanes (``extract.grouped_schedule``), as
K-EXTRACT's; K-XDEMOD-SPEC's run over the whole batch, which measured
faster (:func:`extract_demod_kernel`).

A CUDA tensor launches the kernels (or raises); a CPU tensor runs the
plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import extract, fft_rows
from radiocore_tpu_torch.kernels.extract import extract_rows_plain
from radiocore_tpu_torch.kernels.fft_rows import MIN_ROW, Pass, LaunchCounter
from radiocore_tpu_torch.kernels.quad_demod import quad_demod_plain

MAX_DEMOD_ROW = 1 << 18
LANES = 128     # the JAX kernel's lane digit, for its A == C rule
# The demod pass's block: (P + 1)·n2/16 threads, P rows and a halo row.
# csrc/extract_demod.cu builds it for at most 288 threads at three blocks
# per SM: P = 8 at n2 = 512, which measured faster on an H100 than P = 16
# (544 threads; PERF.md), for K-XDEMOD as for K-XDEMOD-SPEC.
DEMOD_MAX_THREADS = 288     # csrc/extract_demod.cu kDemodThreads
DEMOD_ROWS = 8              # rows per block at most (P)

# csrc/extract_demod.cu atan2_fast: atan(z) = z + z³·Q(z²) on [0, 1], Q's
# coefficients from the highest power down.
ATAN_Q = (0.00738483341, -0.0355649926, 0.0822363347, -0.134035528,
          0.198633403, -0.333255589)

launches = LaunchCounter()        # K-XDEMOD
spec_launches = LaunchCounter()   # K-XDEMOD-SPEC


def extract_demod_ok(n: int, m: int, c: int) -> bool:
    """Whether the fused extract+demod kernel supports this plan (the JAX
    package's accepted set)."""
    return ((m & (m - 1)) == 0 and MIN_ROW <= m <= MAX_DEMOD_ROW
            and n % m == 0 and n // m >= 2 and c <= n // m)


def _digits(m: int) -> Tuple[int, int, int]:
    """The JAX kernel's ``m = A·B·C`` (``fft_pallas._digits``)."""
    rest = m // LANES
    if rest <= LANES:
        return rest, 1, LANES
    return LANES, rest // LANES, LANES


def extract_demod_spec_ok(n: int, m: int, c: int) -> bool:
    """:func:`extract_demod_ok` and the JAX kernel's ``A == C`` rule
    (m ≥ 2^14), so that both packages route the same plans."""
    if not extract_demod_ok(n, m, c):
        return False
    a_n, _b, c_n = _digits(m)
    return a_n == c_n


@dataclasses.dataclass(frozen=True)
class DemodPlan:
    """``first``: K-EXTRACT's first pass (extraction load), ``x → s``.
    ``demod``: the demod pass, rows ``s`` of n2 points, ``s → y`` (quad)
    or ``s → t`` (SPEC, ``tw_n = m``). ``keep``: SPEC's last pass (a
    K-FFT pass with the keep store), ``t → y``."""
    first: Pass
    demod: Pass
    keep: Optional[Pass]

    @property
    def passes(self) -> Tuple[Pass, ...]:
        return tuple(p for p in (self.first, self.demod, self.keep) if p)


def demod_threads(rows: int, n2: int) -> int:
    """Threads of a demod block of ``rows`` rows and the halo row."""
    return (rows + 1) * n2 // fft_rows.POINTS_PER_THREAD


def quad_pitch(n2: int, rows: int) -> int:
    """Floats between the rows of K-XDEMOD's staged quad
    (``csrc/extract_demod.cu`` ``quad_pitch``): the store reads four rows
    at one k per thread, and the pitch puts a warp's ``rows/4`` row
    groups ``32/(rows/4)`` banks apart."""
    return n2 + (32 // rows if 4 <= rows <= 32 else 1)


def demod_smem_bytes(rows: int, n2: int) -> int:
    """Shared memory of a demod block: ``rows + 1`` transformed rows of
    complex64 at ``fft_common.cuh``'s ``row_pitch``. K-XDEMOD's staged
    quad (``rows`` float32 rows at :func:`quad_pitch`) takes their place
    once every row has read its neighbour."""
    row_pitch = n2 + n2 // 16 + 1
    assert 4 * rows * quad_pitch(n2, rows) <= 8 * (rows + 1) * row_pitch
    return 8 * (rows + 1) * row_pitch


def atan2_fast_model(y, x) -> np.ndarray:
    """numpy float32 model of the kernels' discriminator
    (``csrc/extract_demod.cu`` ``atan2_fast``), operation for operation
    (each FMA rounded once): z = min/max of the magnitudes, the odd
    polynomial :data:`ATAN_Q`, octant and quadrant by selects. 0 at the
    origin; a zero ``y`` counts as +0."""
    f32 = np.float32
    y = np.asarray(y, f32)
    x = np.asarray(x, f32)

    def fma(a, b, c):
        return (a.astype(np.float64) * b.astype(np.float64)
                + np.float64(c)).astype(f32)

    ax, ay = np.abs(x), np.abs(y)
    hi, lo = np.maximum(ax, ay), np.minimum(ax, ay)
    with np.errstate(invalid="ignore", divide="ignore"):
        z = np.where(hi == 0, f32(0), lo / hi).astype(f32)
    s = z * z
    q = np.full_like(z, f32(ATAN_Q[0]))
    for coef in ATAN_Q[1:]:
        q = fma(q, s, f32(coef))
    r = fma(q, z * s, z)
    r = np.where(ay > ax, f32(np.pi / 2) - r, r)
    r = np.where(x < 0, f32(np.pi) - r, r)
    return np.where(y < 0, -r, r).astype(f32)


@functools.lru_cache(maxsize=32)
def plan(m: int, c: int, keep: Optional[int] = None) -> DemodPlan:
    """Passes for ``c`` stations of ``m`` points; ``keep`` (SPEC) is the
    number of forward bins written per station."""
    n1, n2 = fft_rows._split(m)
    group = fft_rows._group
    # j = n2·j1 + j2: the n1-point DFT over j1, twiddled, stored at
    # k1·n2 + j2 (as K-FFT's first pass).
    first = Pass(n1, group(n1, n2), n2, 1, c, 0, m, 1, n2, 0, m, 1, n2, m,
                 "x", "s")
    # Row s = k1 (n2 points, unit stride) → x̃[t] at t = s + n1·k. SPEC:
    # the forward split j = s + n1·k has the quad rows as its first
    # pass's inputs; output (k1', s) at k1'·n1 + s, the same strides.
    # The demod block also holds a halo row: (P + 1)·n2/16 threads at
    # most the kernel's block.
    p_demod = min(group(n2, n1), DEMOD_ROWS)
    while p_demod > 1 and demod_threads(p_demod, n2) > DEMOD_MAX_THREADS:
        p_demod //= 2
    demod = Pass(n2, p_demod, n1, 1, c, 0, m, n2, 1, 0, m, 1, n1,
                 m if keep else 0, "s", "t" if keep else "y")
    if not keep:
        return DemodPlan(first, demod, None)
    # Row k1' (n1 points at k1'·n1): the DFT over s gives bin
    # k1' + n2·k2', stored below ``keep`` only.
    last = Pass(n1, group(n1, n2), n2, 1, c, 0, m, n1, 1, 0, keep, 1, n2, 0,
                "t", "y", keep=keep)
    return DemodPlan(first, demod, last)


def atan2_fast(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernels' discriminator on its own, elementwise on float32
    tensors of one shape: ``csrc/extract_demod.cu``'s ``atan2_fast`` on
    CUDA tensors, :func:`atan2_fast_model` on CPU ones."""
    if y.dtype != torch.float32 or x.dtype != torch.float32 \
            or y.shape != x.shape or y.device != x.device:
        raise ValueError("atan2_fast: two float32 tensors of one shape on "
                         "one device")
    if not _use_kernel(y):
        return torch.from_numpy(atan2_fast_model(y.numpy(), x.numpy()))
    from radiocore_tpu_torch.kernels import build
    y, x = y.contiguous(), x.contiguous()
    out = torch.empty_like(y)
    if y.numel():
        err = build.library().rc_atan2_fast(
            y.data_ptr(), x.data_ptr(), out.data_ptr(), y.numel(),
            torch.cuda.current_stream().cuda_stream)
        build.check(err, f"rc_atan2_fast(n={y.numel()})")
    return out


def _check(spectrum: torch.Tensor, c: int, m: int, what: str, ok) -> int:
    if spectrum.dim() != 1:
        raise ValueError(f"{what}: 1-D spectrum only")
    n = int(spectrum.shape[-1])
    if not ok(n, m, c):
        raise ValueError(f"{what}: unsupported plan n={n} m={m} c={c}")
    return n


def _keep_bins(m: int, keep_bins: Optional[int]) -> int:
    if keep_bins is None:
        return m
    if not 0 < keep_bins <= m:
        raise ValueError(f"keep_bins {keep_bins} out of (0, {m}]")
    return int(keep_bins)


@functools.lru_cache(maxsize=32)
def _records(m: int, c: int, keep: Optional[int]):
    return fft_rows.pass_records(plan(m, c, keep).passes)


def extract_demod_kernel(spectrum: torch.Tensor, a0: int, c: int, m: int,
                         gain: float, keep: Optional[int],
                         group: Optional[int] = None,
                         lanes: Optional[int] = None) -> torch.Tensor:
    """The CUDA route of :func:`extract_demod_rows` (``keep`` None) and
    :func:`extract_demod_spec_rows`. Buffers: the result, ``(c, m)``
    float32 or ``(c, keep)`` complex64; the scratch ``s`` of
    ``lanes·G·m`` complex64 points and, for SPEC, ``t`` of the same size,
    which the station groups reuse in turn. ``group`` and ``lanes`` are
    the schedule, for timing one against another; the result does not
    depend on them. By default K-XDEMOD takes
    ``extract.grouped_schedule`` (32 MB of ``s`` for 2 lanes of G = 8
    stations of 2^18); K-XDEMOD-SPEC, whose three passes per group would
    be of 4 stations, too few to fill the card, measured slower grouped
    on an H100 (PERF.md) and runs its passes over the whole batch
    (``group = c``: ``s`` and ``t`` of the result's station count). One C
    call enqueues every launch, ordered on the current stream (see
    ``extract.extract_rows_kernel``)."""
    from radiocore_tpu_torch.kernels import build
    if spectrum.dtype != torch.complex64:
        raise TypeError(f"extract_demod: kernel takes complex64, "
                        f"got {spectrum.dtype}")
    if not spectrum.is_contiguous():
        raise ValueError("extract_demod: kernel takes a contiguous spectrum")
    n = int(spectrum.shape[-1])
    lib = build.library()
    dev = spectrum.device
    if group is None:
        group, lanes = (c, 1) if keep else extract.grouped_schedule(dev, m,
                                                                    1, c)
    group = max(1, min(int(group), c))
    lanes = max(1, min(int(lanes or 1), extract.MAX_LANES, -(-c // group)))
    s = torch.empty(lanes * group * m, dtype=torch.complex64, device=dev)
    if keep:
        t = torch.empty(lanes * group * m, dtype=torch.complex64, device=dev)
        y = torch.empty((c, keep), dtype=torch.complex64, device=dev)
    else:
        t = None
        y = torch.empty((c, m), dtype=torch.float32, device=dev)
    made = ctypes.c_int(0)
    err = lib.rc_extract_demod(
        spectrum.data_ptr(), y.data_ptr(), s.data_ptr(),
        t.data_ptr() if t is not None else None,
        _records(m, c, keep), c, group, lanes, n, m, int(a0),
        float(gain), keep or 0,
        torch.cuda.current_stream().cuda_stream, ctypes.byref(made))
    (spec_launches if keep else launches).count += made.value
    build.check(err, f"rc_extract_demod(m={m}, c={c}, keep={keep}, "
                     f"group={group})")
    return y


def extract_demod_rows_plain(spectrum: torch.Tensor, a0: int, c: int,
                             m: int, gain: Optional[float] = None
                             ) -> torch.Tensor:
    """Plain version: ``quad_demod_plain(extract_rows_plain(...))``, plain
    PyTorch on the card too."""
    n = int(spectrum.shape[-1])
    return quad_demod_plain(extract_rows_plain(spectrum, a0, c, m, 1.0 / n),
                            gain)


def extract_demod_spec_rows_plain(spectrum: torch.Tensor, a0: int, c: int,
                                  m: int, gain: Optional[float] = None,
                                  keep_bins: Optional[int] = None
                                  ) -> torch.Tensor:
    """Plain version: ``torch.fft.fft`` of the plain quad, first K bins."""
    k = _keep_bins(m, keep_bins)
    quad = extract_demod_rows_plain(spectrum, a0, c, m, gain)
    return torch.fft.fft(quad, dim=-1)[:, :k]


def _use_kernel(spectrum: torch.Tensor) -> bool:
    """True for a CUDA tensor; False for a CPU one; raise otherwise."""
    if spectrum.is_cuda:
        return True
    if spectrum.device.type != "cpu":
        raise ValueError(f"extract_demod: no kernel for {spectrum.device}")
    return False


def _gain(gain: Optional[float]) -> float:
    return 1.0 / math.pi if gain is None else float(gain)


def extract_demod_rows(spectrum: torch.Tensor, a0: int, c: int, m: int,
                       gain: Optional[float] = None) -> torch.Tensor:
    """Uniform-plan extraction + FM quadrature demod: ``spectrum (n,) c64
    → quad (c, m) f32``; station i's run starts at bin ``(a0 + i·m) mod
    n``. Default ``gain`` 1/π; ``quad[:, 0] = 0``."""
    n = _check(spectrum, c, m, "extract_demod_rows", extract_demod_ok)
    a0 = int(a0) % n
    if _use_kernel(spectrum):
        return extract_demod_kernel(spectrum, a0, c, m, _gain(gain), None)
    return extract_demod_rows_plain(spectrum, a0, c, m, gain)


def extract_demod_spec_rows(spectrum: torch.Tensor, a0: int, c: int,
                            m: int, gain: Optional[float] = None,
                            keep_bins: Optional[int] = None
                            ) -> torch.Tensor:
    """:func:`extract_demod_rows`, then the forward m-point DFT of each
    quad row: ``(c, K)`` c64 with ``K = keep_bins`` (default m) — bins
    below ``m//2 + 1`` are ``rfft(quad)``."""
    n = _check(spectrum, c, m, "extract_demod_spec_rows",
               extract_demod_spec_ok)
    k = _keep_bins(m, keep_bins)
    a0 = int(a0) % n
    if _use_kernel(spectrum):
        return extract_demod_kernel(spectrum, a0, c, m, _gain(gain), k)
    return extract_demod_spec_rows_plain(spectrum, a0, c, m, gain, k)

"""K-EXTRACT: fused channel extraction (window + Nyquist fold + backward
DFT + roll flip), hand-written for Hopper.

Counterpart of ``radiocore_tpu/kernels/extract_pallas.py``. Station i's
m-bin run starts at spectrum bin ``(a0 + i·m) mod n``; the kernel
(``csrc/extract.cu``) is K-FFT's pass plan for m-point rows with the
window, fold and ``s_norm`` scale as the first pass's load prologue and
the ``(−1)^t`` flip as the last pass's store epilogue, so it reads the
runs in place and writes the station IQ once. A station of more than
4096 points takes two passes with a scratch between them; the passes run
per group of G stations (:func:`grouped_schedule`), the groups dealt over
lanes with a G-station scratch each that the lane's next group
overwrites, so the scratch stays in the card's L2 and kernels of
neighbouring groups overlap.

K-GATHER (``csrc/extract_gather.cu``, :func:`extract_gather`) is the
extraction's reorder for any other plan: every station's run gathered in
place (mod n) into the output order of ``ops/channelize``'s reorder,
windowed, scaled and with the even-m fix bin folded, in one launch. The
inverse transform follows it as a library call, unnormalized: the
extractor folds the whole scale into the window. Each output row reads
its own spectrum from its own start (:func:`extract_gather_rows`), so a
batch of bands with a plan each takes one launch as well.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs
:func:`extract_rows_plain` or :func:`extract_gather_rows_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.kernels.fft_rows import (MAX_ROW, MIN_ROW, Pass,
                                                  LaunchCounter)

LOAD_STRIDED, LOAD_EXTRACT = 0, 1
STORE_STRIDED, STORE_FLIP = 0, 1

launches = LaunchCounter()
gather_launches = LaunchCounter()   # K-GATHER

# The grouped schedule (measured on an H100, PERF.md): the passes run per
# group of G stations, the groups dealt in turn over LANES streams with a
# scratch set each, so that kernels of neighbouring groups overlap. All
# lanes' scratch together takes at most L2_SHARE of the L2 (the spectrum
# streaming in and the result streaming out share the cache): at 2^18
# points G = 8 on two lanes, 32 MB of an H100's 50 MB. One lane, or a third
# of the L2, measured slower than the passes over the whole batch: a group
# must fill the SMs (8 stations are 256 blocks) and two must be in flight.
L2_SHARE = (2, 3)
LANES = 2
MAX_LANES = 4           # csrc/fft_common.cuh kMaxLanes


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


def group_size(l2_bytes: int, m: int, buffers: int, c: int,
               lanes: int = 1) -> int:
    """Stations per group: the most whose scratch (``buffers`` complex64
    arrays of ``m`` points per station, for each of ``lanes`` groups in
    flight) fits :data:`L2_SHARE` of an L2 of ``l2_bytes``; at least 1,
    at most ``c``."""
    num, den = L2_SHARE
    return max(1, min(c, l2_bytes * num // (den * lanes * buffers * m * 8)))


@functools.lru_cache(maxsize=8)
def l2_cache_bytes(device_index: int) -> int:
    """The L2 size of a CUDA device (``cudaDevAttrL2CacheSize``)."""
    import torch.cuda
    from radiocore_tpu_torch.kernels import build
    size = ctypes.c_longlong(0)
    with torch.cuda.device(device_index):
        build.check(build.library().rc_l2_cache_bytes(ctypes.byref(size)),
                    "rc_l2_cache_bytes")
    return int(size.value)


def grouped_schedule(device: torch.device, m: int, buffers: int,
                     c: int) -> Tuple[int, int]:
    """``(group, lanes)`` of the grouped schedule on ``device``:
    :data:`LANES` lanes and the :func:`group_size` its L2 gives them."""
    return (group_size(l2_cache_bytes(device.index), m, buffers, c, LANES),
            LANES)


def grouped_launches(passes: Sequence[Pass], c: int, group: int, a0: int,
                     n: int, m: int, lanes: int = 1
                     ) -> Iterator[Tuple[Pass, int, int, int]]:
    """The launches of a grouped schedule, in order, as the C entry points
    (``rc_extract_rows``, ``rc_extract_demod``) make them: for each group
    of ``group`` stations from station g0, every pass with ``B1`` = the
    group's station count, as ``(pass, a0_g, dst_offset, scratch_offset)``.
    ``a0_g = (a0 + g0·m) mod n`` is the group's start bin for the
    extraction load; ``dst_offset = g0·ob1`` where the pass writes the
    result ``"y"``; ``scratch_offset = lane·group·m`` into each scratch
    buffer, group i on lane ``i mod lanes``: a lane's scratch holds one
    group and is reused by the lane's next. A one-pass plan (its rows are
    the sub-FFT index, no scratch) is one launch over the whole batch."""
    if len(passes) == 1:
        yield passes[0], a0, 0, 0
        return
    for i, g0 in enumerate(range(0, c, group)):
        cg = min(group, c - g0)
        for p in passes:
            yield (dataclasses.replace(p, B1=cg), (a0 + g0 * m) % n,
                   g0 * p.ob1 if p.dst == "y" else 0,
                   (i % lanes) * group * m)


@functools.lru_cache(maxsize=32)
def _records(m: int, c: int):
    return fft_rows.pass_records([p for p, _, _ in extract_passes(m, c)])


def extract_rows_kernel(spectrum: torch.Tensor, a0: int, c: int, m: int,
                        s_norm: float, group: Optional[int] = None,
                        lanes: Optional[int] = None) -> torch.Tensor:
    """The CUDA route of :func:`extract_rows`. Buffers: the result
    ``(c, m)`` complex64 and, for a two-pass plan (m > 4096), one scratch
    of ``lanes·G·m`` complex64 points (32 MB for 2 lanes of G = 8
    stations of 2^18) that the station groups reuse in turn. ``group``
    and ``lanes`` (default :func:`grouped_schedule`; ``group=c`` runs the
    passes over the whole batch) are the schedule, for timing one against
    another; the result does not depend on them. One C call enqueues
    every launch, ordered on the current stream: the side streams start
    after what that stream holds and it waits for them, so the scratch,
    allocated on it, is safe to free when this returns."""
    from radiocore_tpu_torch.kernels import build
    if spectrum.dtype != torch.complex64:
        raise TypeError(f"extract_rows: kernel takes complex64, "
                        f"got {spectrum.dtype}")
    if not spectrum.is_contiguous():
        raise ValueError("extract_rows: kernel takes a contiguous spectrum")
    n = int(spectrum.shape[-1])
    lib = build.library()
    dev = spectrum.device
    records = _records(m, c)
    npass = len(records) // fft_rows.PASS_FIELDS
    if npass == 1:
        group = c
    elif group is None:
        group, lanes = grouped_schedule(dev, m, 1, c)
    group = max(1, min(int(group), c))
    lanes = max(1, min(int(lanes or 1), MAX_LANES, -(-c // group)))
    y = torch.empty((c, m), dtype=torch.complex64, device=dev)
    scratch = (torch.empty(lanes * group * m, dtype=torch.complex64,
                           device=dev) if npass > 1 else None)
    made = ctypes.c_int(0)
    err = lib.rc_extract_rows(
        spectrum.data_ptr(), y.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, records, npass,
        c, group, lanes, n, m, int(a0), float(s_norm),
        torch.cuda.current_stream().cuda_stream, ctypes.byref(made))
    launches.count += made.value
    build.check(err, f"rc_extract_rows(m={m}, c={c}, group={group})")
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
        return extract_rows_kernel(spectrum, a0, c, m, s_norm)
    if spectrum.device.type != "cpu":
        raise ValueError(f"extract_rows: no kernel for {spectrum.device}")
    return extract_rows_plain(spectrum, a0, c, m, s_norm)


def gather_ok(n: int, m: int) -> bool:
    """Whether K-GATHER takes a plan of ``m``-point stations in ``n``
    bins: a station's run (``m`` bins, and the fix bin for an even m)
    fits the spectrum once."""
    return 1 <= m <= n - (1 - m % 2)


def _as_rows(spectrum: torch.Tensor, starts: torch.Tensor):
    """One plan over a batch of spectra as K-GATHER's rows: ``spectrum
    (..., n)`` as ``(batch, n)`` and each row's flat start ``b·n +
    starts[c]`` (``starts`` itself for one spectrum)."""
    if starts.dim() != 1 or starts.shape[0] < 1:
        raise ValueError("extract_gather: starts must be (C,), C >= 1")
    n = int(spectrum.shape[-1])
    batch = spectrum.numel() // n
    at = starts
    if batch != 1:
        at = (starts + torch.arange(0, batch * n, n,
                                    device=starts.device)[:, None])
    return spectrum.reshape(batch, n), at.reshape(-1)


def extract_gather_plain(spectrum: torch.Tensor, starts: torch.Tensor,
                         window: torch.Tensor,
                         fix: Optional[float]) -> torch.Tensor:
    """Plain version of :func:`extract_gather`: ``spectrum (..., n) →
    (..., C, m)``, by :func:`extract_gather_rows_plain`."""
    lead = spectrum.shape[:-1]
    return extract_gather_rows_plain(*_as_rows(spectrum, starts), window,
                                     fix).reshape(lead + (starts.shape[0], -1))


def extract_gather(spectrum: torch.Tensor, starts: torch.Tensor,
                   window: torch.Tensor,
                   fix: Optional[float] = None) -> torch.Tensor:
    """The extraction's reorder for one plan: ``spectrum (..., n) →
    (..., C, m)``, station c's run from bin ``starts[c]`` (``(C,)``
    int64 on the spectrum's device) in ``make_extractor``'s output order,
    times ``window`` (``(m,)`` float32 there, the scale folded in), and
    for an even m the fix bin times ``fix``: :func:`extract_gather_rows`
    over the batch's spectra, one K-GATHER launch for a CUDA tensor."""
    lead = spectrum.shape[:-1]
    return extract_gather_rows(*_as_rows(spectrum, starts), window,
                               fix).reshape(lead + (starts.shape[0], -1))


def extract_gather_rows_plain(spectra: torch.Tensor, at: torch.Tensor,
                              window: torch.Tensor,
                              fix: Optional[float]) -> torch.Tensor:
    """Plain version of :func:`extract_gather_rows`: ``spectra (B, n) →
    (R, m)``, row r's bins gathered by index from spectrum ``at[r] // n``
    from bin ``at[r] mod n``, times ``window`` (``m`` points, output
    order, scale folded in); an even m adds the fix bin (run bin 0) times
    ``fix`` to output ``m//2``. Output j is run bin ``lead + neg + j`` for
    ``j < m2`` and ``lead + j − m2`` after (``m2 = m//2 + 1``, ``neg = m −
    m2``, ``lead`` = 1 for an even m: the fix bin)."""
    n = int(spectra.shape[-1])
    m = int(window.shape[-1])
    m2 = m // 2 + 1
    flat = spectra.reshape(-1)
    band, start = at // n, at % n
    j = torch.arange(m, device=at.device)
    off = (1 - m % 2) + torch.where(j < m2, m - m2 + j, j - m2)
    y = flat[band[:, None] * n + (start[:, None] + off) % n] * window
    if m % 2 == 0:
        y[:, m // 2] += flat[at] * fix
    return y


def _gather_kernel(spectra: torch.Tensor, at: torch.Tensor,
                   window: torch.Tensor, fix: Optional[float]
                   ) -> torch.Tensor:
    from radiocore_tpu_torch.kernels import build
    if spectra.dtype != torch.complex64 or window.dtype != torch.float32:
        raise TypeError(f"extract_gather: kernel takes complex64 spectra "
                        f"and a float32 window, got {spectra.dtype} and "
                        f"{window.dtype}")
    if not spectra.is_contiguous():
        raise ValueError("extract_gather: kernel takes contiguous spectra")
    if (at.dtype != torch.int64 or not at.is_contiguous()
            or not window.is_contiguous()):
        raise ValueError("extract_gather: kernel takes contiguous int64 "
                         "starts and a contiguous window")
    n = int(spectra.shape[-1])
    m = int(window.shape[-1])
    rows = int(at.shape[0])
    y = torch.empty((rows, m), dtype=torch.complex64, device=spectra.device)
    err = build.library().rc_extract_gather(
        spectra.data_ptr(), y.data_ptr(), at.data_ptr(), window.data_ptr(),
        n, rows, m, float(fix or 0.0),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_extract_gather(n={n}, m={m}, rows={rows})")
    gather_launches.count += 1
    return y


def extract_gather_rows(spectra: torch.Tensor, at: torch.Tensor,
                        window: torch.Tensor,
                        fix: Optional[float] = None) -> torch.Tensor:
    """The reorder with a start a row: ``spectra (B, n) → (R, m)``, row r
    the run of spectrum ``at[r] // n`` from bin ``at[r] mod n`` (``at``:
    ``(R,)`` int64 on the spectra's device, each in ``[0, B·n)``), in
    ``make_extractor``'s output order, window and fix bin, so that a batch
    of bands with a plan each takes one launch and each row is bit for
    bit what :func:`extract_gather` writes for its band alone. K-GATHER
    (one launch) for a CUDA tensor, :func:`extract_gather_rows_plain` for
    a CPU one."""
    if spectra.dim() != 2:
        raise ValueError(f"extract_gather: spectra must be (B, n), got "
                         f"{tuple(spectra.shape)}")
    n = int(spectra.shape[-1])
    m = int(window.shape[-1])
    if not gather_ok(n, m):
        raise ValueError(f"extract_gather: {m}-point stations do not fit "
                         f"{n} bins")
    if (m % 2 == 0) != (fix is not None):
        raise ValueError(f"extract_gather: an even m takes a fix weight, "
                         f"an odd one none (m={m}, fix={fix})")
    if at.dim() != 1 or at.shape[0] < 1:
        raise ValueError("extract_gather: at must be (R,), R >= 1")
    if spectra.is_cuda:
        return _gather_kernel(spectra, at, window, fix)
    if spectra.device.type != "cpu":
        raise ValueError(f"extract_gather: no kernel for {spectra.device}")
    return extract_gather_rows_plain(spectra, at, window, fix)

"""Batched channel extraction from a full-band spectrum; counterpart of
``radiocore_tpu/ops/channelize.py``.

For channel c with spectrum roll ``s_c``, scipy's
``resample(roll(X, s_c)·W, m, domain='freq')`` keeps bins that form one
contiguous (wrapping) run of the unrolled spectrum, so extraction is a
static slice per channel, a reorder with the window, and one batched
IFFT. ``routes.extract_ifft`` picks the lowering, as the reference's
``RADIOCORE_TPU_EXTRACT_IFFT`` does:

- ``auto``: a plan whose runs tile the band uniformly goes, for a 1-D
  CUDA spectrum that ``extract_ok`` accepts, to K-EXTRACT
  (``kernels/extract.py``); any other plan on a complex64 CUDA
  spectrum (any spacing, any m, batched spectra too) to K-GATHER, the
  reorder in one launch with the whole scale 1/n folded into its window,
  then ``ops.fft.ifft_unscaled`` (``ifft``'s route without its
  normalization pass); a CPU spectrum as ``native``;
- ``fused``: the same, and K-EXTRACT's plain version for a CPU spectrum
  whose plan it takes;
- ``pallas``: the reorder in torch, then K-FFT's ``fft_pow2`` backward
  with the whole scale ``1/(s_fac·m)`` folded into its input, when m is
  a power of two in ``[MIN_ROW, MAX_ROW]`` (its plain version on the
  CPU); ``native`` otherwise;
- ``fourstep``: the reorder, then ``ops.fft.ifft_decomposed``;
- ``native``: the reorder, then ``ops.fft.ifft``.

The reorder in torch (``native``, ``fourstep``, ``pallas``, and every
CPU spectrum) is K-GATHER's counterpart on the card.

A batch of bands of one rate, each with its own plan
(:func:`make_band_extractor`), takes one K-GATHER launch over every band's
stations on a complex64 CUDA batch under ``auto`` and ``fused``, then one
inverse over all rows, where no band's plan is one K-EXTRACT takes;
otherwise each band's own extractor, the rows joined band after band.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.kernels.extract import (extract_gather,
                                                 extract_gather_rows,
                                                 extract_ok, extract_rows,
                                                 gather_ok)
from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.consts import HostConst
from radiocore_tpu_torch.runtime.graphs import device_cache
from radiocore_tpu_torch.runtime.routes import Routes, resolve


def extraction_plan(n: int, shifts: Sequence[int], bandwidth: int):
    """Host-side constants: slice starts, window vector, fix weight."""
    m = int(bandwidth)
    m2 = m // 2 + 1
    win = np.fft.fftshift(design.window("hann", n))

    neg = m - m2                       # number of negative-frequency bins
    run = m + (1 if m % 2 == 0 else 0)  # extra leading fix bin when even
    # Rolled-bin positions covered by the run, in slice order.
    if m % 2 == 0:
        rolled = np.concatenate([[n - m // 2],
                                 np.arange(n - neg, n), np.arange(m2)])
    else:
        rolled = np.concatenate([np.arange(n - neg, n), np.arange(m2)])
    starts = [int((rolled[0] - s) % n) for s in shifts]

    # Window sampled at rolled positions, in OUTPUT order [pos, neg].
    w_out = np.concatenate([win[:m2], win[n - neg:]]).astype(np.float32)
    w_fix = np.float32(win[n - m // 2]) if m % 2 == 0 else None
    return starts, w_out, w_fix, m2, run


def _is_uniform(n: int, starts: Sequence[int], m: int) -> bool:
    c = len(starts)
    return (c > 1 and n >= c * m
            and all((starts[i] - starts[0]) % n == (i * m) % n
                    for i in range(c)))


def uniform_extraction_start(n: int, shifts: Sequence[int],
                             bandwidth: int):
    """First slice start ``a0`` when the plan tiles the band uniformly
    with spacing == bandwidth (the fused-kernel layout), else None."""
    m = int(bandwidth)
    starts = extraction_plan(n, shifts, m)[0]
    return starts[0] if _is_uniform(n, starts, m) else None


def make_extractor(n: int, shifts: Sequence[int], bandwidth: int,
                   routes: Optional[Routes] = None
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``spectrum (..., n) → channels (..., C, bandwidth)``.

    The reorder by K-EXTRACT, K-GATHER or torch, and the inverse
    transform, by ``routes.extract_ifft`` (module docstring). Built once
    per plan and routes: two routes give two extractors. The extractor's
    ``reorder`` and ``gather`` attributes give the torch reorder and
    K-GATHER's, each ``(..., C, m)`` times the whole scale 1/n, the
    input of an unnormalized inverse.
    """
    return _extractor(int(n), tuple(int(s) for s in shifts), int(bandwidth),
                      resolve(routes))


@device_cache(maxsize=32)
def _extractor(n: int, shifts: Tuple[int, ...], m: int,
               routes: Routes) -> Callable[[torch.Tensor], torch.Tensor]:
    c = len(shifts)
    starts, w_out, w_fix, m2, run = extraction_plan(n, shifts, m)
    neg = m - m2
    s_fac = n / m
    w_c = HostConst(w_out)
    fix = float(w_fix) if w_fix is not None else None
    # K-GATHER's constants: the starts, and the window and fix weight with
    # the whole scale 1/n (1/s_fac and the inverse's 1/m) folded in,
    # rounded once from float64.
    starts_c = HostConst(np.asarray(starts, np.int64))
    wg_c = HostConst((w_out.astype(np.float64) / n).astype(np.float32))
    fix_g = (float(np.float32(np.float64(w_fix) / n))
             if w_fix is not None else None)
    impl = routes.extract_ifft
    uniform = _is_uniform(n, starts, m)
    row = ((m & (m - 1)) == 0
           and fft_rows.MIN_ROW <= m <= fft_rows.MAX_ROW)

    def finish(y_all: torch.Tensor) -> torch.Tensor:
        if impl == "pallas" and row:
            # The unnormalized backward DFT with the whole scale folded
            # into its input, as the reference's ``pallas`` route.
            return fft_rows.fft_pow2((y_all / (s_fac * m)).contiguous(),
                                     +1.0)
        if impl == "fourstep":
            return _fft.ifft_decomposed(y_all / s_fac, routes)
        return _fft.ifft(y_all / s_fac, routes)

    def kernel_ok(spectrum: torch.Tensor) -> bool:
        """K-EXTRACT takes the plan (or its plain version on the CPU)."""
        if (not uniform or impl not in ("auto", "fused") or m % 2
                or spectrum.dim() != 1):
            return False
        if impl == "auto" and not spectrum.is_cuda:
            return False
        return extract_ok(n, m, c)

    def gather_route(spectrum: torch.Tensor) -> bool:
        """K-GATHER takes every other plan on a complex64 CUDA spectrum."""
        return (impl in ("auto", "fused") and spectrum.is_cuda
                and spectrum.dtype == torch.complex64 and gather_ok(n, m))

    def gather_rows(spectrum: torch.Tensor) -> torch.Tensor:
        """K-GATHER: every station's windowed run times 1/n, (..., C, m),
        ready for the unnormalized inverse."""
        dev = spectrum.device
        return extract_gather(spectrum.contiguous(), starts_c.on(dev),
                              wg_c.on(dev), fix_g)

    def reorder(sl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Run ``sl`` (..., run) in raw order → windowed output order."""
        if m % 2 == 0:
            y = torch.cat([sl[..., m // 2:m + 1], sl[..., 1:m // 2]],
                          dim=-1) * w
            y[..., m2 - 1] += sl[..., 0] * fix
        else:
            y = torch.cat([sl[..., neg:m], sl[..., :neg]], dim=-1) * w
        return y

    def reorder_rows(spectrum: torch.Tensor) -> torch.Tensor:
        """The reorder in torch: every station's windowed run, unscaled.
        A uniform plan's runs are one rolled spectrum reshaped ``(C, m)``;
        otherwise one static slice per station of a wrapped copy."""
        w = w_c.on(spectrum.device)
        if uniform:
            a0 = starts[0]
            base = torch.cat([spectrum[..., a0:], spectrum[..., :a0],
                              spectrum[..., a0:a0 + 1]],
                             dim=-1)[..., :c * m + 1]
            rows = base[..., :c * m].reshape(spectrum.shape[:-1] + (c, m))
            # Element ``m`` of each run is the next row's first element.
            nxt = torch.cat([rows[..., 1:, :1],
                             base[..., -1:].unsqueeze(-2)], dim=-2)
            return reorder(torch.cat([rows, nxt], dim=-1), w)
        ext = torch.cat([spectrum, spectrum[..., :run]], dim=-1)
        return torch.stack([reorder(ext[..., a0:a0 + run], w)
                            for a0 in starts], dim=-2)

    def extract(spectrum: torch.Tensor) -> torch.Tensor:
        if kernel_ok(spectrum):
            return extract_rows(spectrum.contiguous(), starts[0], c, m,
                                1.0 / (s_fac * m))
        if gather_route(spectrum):
            return _fft.ifft_unscaled(gather_rows(spectrum), routes)
        return finish(reorder_rows(spectrum))

    # The two reorders side by side, each times the whole 1/n (K-GATHER on
    # a CUDA spectrum, its plain version on a CPU one), for holding one
    # against the other.
    extract.reorder = lambda spectrum: reorder_rows(spectrum) / (s_fac * m)
    extract.gather = gather_rows
    extract.kernel_ok = kernel_ok
    # K-GATHER's plan: each station's start, the scaled window, the fix
    # weight.
    extract.gather_plan = (starts, wg_c, fix_g)
    return extract


def make_band_extractor(n: int, band_shifts: Sequence[Sequence[int]],
                        bandwidth: int, routes: Optional[Routes] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``spectra (B, n) → channels (R, bandwidth)`` for B bands of one
    rate, band b's stations at its own rolls ``band_shifts[b]``, the rows
    band after band (R stations in all).

    On a complex64 CUDA batch under ``extract_ifft`` ``auto`` or
    ``fused``, where no band's plan is one that K-EXTRACT takes: one
    K-GATHER launch over every band's stations
    (:func:`~radiocore_tpu_torch.kernels.extract.extract_gather_rows`),
    each row bit for bit what the band's own extractor gathers, then one
    unnormalized inverse over all R rows. Otherwise each band's
    :func:`make_extractor` on its spectrum, the rows joined, so that a
    band whose plan K-EXTRACT takes goes there as it would alone. A batch
    of another shape than ``(B, n)`` raises ``ValueError``. The
    extractor's ``gather`` attribute gives the gathered rows (the
    inverse's input), ``gather_route(spectra)`` whether a batch takes the
    one launch, ``by_band`` the bands' own extractors.
    """
    return _band_extractor(int(n), tuple(tuple(int(s) for s in shifts)
                                         for shifts in band_shifts),
                           int(bandwidth), resolve(routes))


@device_cache(maxsize=8)
def _band_extractor(n: int, band_shifts: Tuple[Tuple[int, ...], ...],
                    m: int, routes: Routes
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    if not band_shifts or not all(band_shifts):
        raise ValueError("make_band_extractor: every band needs a station")
    by_band = [_extractor(n, shifts, m, routes) for shifts in band_shifts]
    at_c = HostConst(np.asarray(
        [b * n + a for b, ex in enumerate(by_band)
         for a in ex.gather_plan[0]], np.int64))
    _, wg_c, fix_g = by_band[0].gather_plan
    shape = (len(band_shifts), n)

    def gather_rows(spectra: torch.Tensor) -> torch.Tensor:
        dev = spectra.device
        return extract_gather_rows(spectra.contiguous(), at_c.on(dev),
                                   wg_c.on(dev), fix_g)

    def gather_route(spectra: torch.Tensor) -> bool:
        """One K-GATHER launch over every band: a complex64 CUDA batch,
        and no band's plan one that its own extractor sends to
        K-EXTRACT."""
        return (routes.extract_ifft in ("auto", "fused") and spectra.is_cuda
                and spectra.dtype == torch.complex64 and gather_ok(n, m)
                and not any(ex.kernel_ok(spectra[b])
                            for b, ex in enumerate(by_band)))

    def extract(spectra: torch.Tensor) -> torch.Tensor:
        if tuple(spectra.shape) != shape:
            raise ValueError(f"a batch of {shape[0]} bands of {n} bins is "
                             f"{shape}, got {tuple(spectra.shape)}")
        if gather_route(spectra):
            return _fft.ifft_unscaled(gather_rows(spectra), routes)
        return torch.cat([ex(spectra[b]) for b, ex in enumerate(by_band)])

    extract.gather = gather_rows
    extract.gather_route = gather_route
    extract.by_band = by_band
    return extract

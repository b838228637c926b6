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
  (``kernels/extract.py``); anything else as ``native``;
- ``fused``: the same on either device (K-EXTRACT's plain version for a
  CPU spectrum);
- ``pallas``: the reorder in torch, then K-FFT's ``fft_pow2`` backward
  with the whole scale ``1/(s_fac·m)`` folded into its input, when m is
  a power of two in ``[MIN_ROW, MAX_ROW]`` (its plain version on the
  CPU); ``native`` otherwise;
- ``fourstep``: the reorder, then ``ops.fft.ifft_decomposed``;
- ``native``: the reorder, then ``ops.fft.ifft``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.kernels.extract import extract_ok, extract_rows
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

    Two lowerings: the uniform one (all runs are one rolled spectrum
    reshaped ``(C, m)``) and one static slice per channel otherwise; the
    inverse transform by ``routes.extract_ifft`` (module docstring).
    Built once per plan and routes: two routes give two extractors.
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
    impl = routes.extract_ifft
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
        if impl not in ("auto", "fused") or m % 2 or spectrum.dim() != 1:
            return False
        if impl == "auto" and not spectrum.is_cuda:
            return False
        return extract_ok(n, m, c)

    def reorder(sl: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Run ``sl`` (..., run) in raw order → windowed output order."""
        if m % 2 == 0:
            y = torch.cat([sl[..., m // 2:m + 1], sl[..., 1:m // 2]],
                          dim=-1) * w
            y[..., m2 - 1] += sl[..., 0] * fix
        else:
            y = torch.cat([sl[..., neg:m], sl[..., :neg]], dim=-1) * w
        return y

    def extract_uniform(spectrum: torch.Tensor) -> torch.Tensor:
        a0 = starts[0]
        if kernel_ok(spectrum):
            return extract_rows(spectrum.contiguous(), a0, c, m,
                                1.0 / (s_fac * m))
        base = torch.cat([spectrum[..., a0:], spectrum[..., :a0],
                          spectrum[..., a0:a0 + 1]], dim=-1)[..., :c * m + 1]
        rows = base[..., :c * m].reshape(spectrum.shape[:-1] + (c, m))
        # Element ``m`` of each run is the next row's first element.
        nxt = torch.cat([rows[..., 1:, :1], base[..., -1:].unsqueeze(-2)],
                        dim=-2)
        return finish(reorder(torch.cat([rows, nxt], dim=-1),
                              w_c.on(spectrum.device)))

    def extract_slices(spectrum: torch.Tensor) -> torch.Tensor:
        ext = torch.cat([spectrum, spectrum[..., :run]], dim=-1)
        w = w_c.on(spectrum.device)
        rows = [reorder(ext[..., a0:a0 + run], w) for a0 in starts]
        return finish(torch.stack(rows, dim=-2))

    return extract_uniform if _is_uniform(n, starts, m) else extract_slices

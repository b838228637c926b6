"""Batched channel extraction from a full-band spectrum; counterpart of
``radiocore_tpu/ops/channelize.py``.

For channel c with spectrum roll ``s_c``, scipy's
``resample(roll(X, s_c)·W, m, domain='freq')`` keeps bins that form one
contiguous (wrapping) run of the unrolled spectrum, so extraction is a
static slice per channel, a reorder with the window, and one batched
IFFT. A plan whose runs tile the band uniformly goes, for a 1-D CUDA
spectrum that ``extract_ok`` accepts, to K-EXTRACT
(``kernels/extract.py``).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels.extract import extract_ok, extract_rows
from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.consts import HostConst


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


@functools.lru_cache(maxsize=32)
def make_extractor(n: int, shifts: Tuple[int, ...],
                   bandwidth: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """``spectrum (..., n) → channels (..., C, bandwidth)``.

    Two lowerings: the uniform one (all runs are one rolled spectrum
    reshaped ``(C, m)``) and one static slice per channel otherwise.
    """
    m = int(bandwidth)
    c = len(shifts)
    starts, w_out, w_fix, m2, run = extraction_plan(n, shifts, m)
    neg = m - m2
    s_fac = n / m
    w_c = HostConst(w_out)
    fix = float(w_fix) if w_fix is not None else None

    def finish(y_all: torch.Tensor) -> torch.Tensor:
        return _fft.ifft(y_all / s_fac)

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
        if (spectrum.is_cuda and m % 2 == 0 and spectrum.dim() == 1
                and extract_ok(n, m, c)):
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

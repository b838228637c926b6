"""Analytic signal (Hilbert transform) and pilot-tone harmonic synthesis;
counterpart of ``radiocore_tpu/ops/analytic.py``."""

from __future__ import annotations

from typing import Optional

import torch

from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.runtime.graphs import device_cache
from radiocore_tpu_torch.runtime.routes import Routes


@device_cache(maxsize=16)
def _hilbert(n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The Hilbert multiplier on ``device``, copied there once per size."""
    return torch.from_numpy(design.hilbert_multiplier(n)).to(
        device=device, dtype=dtype)


def analytic_signal(x: torch.Tensor,
                    routes: Optional[Routes] = None) -> torch.Tensor:
    """Analytic signal along the last axis: FFT, zero the negative
    frequencies, IFFT; as ``scipy.signal.hilbert``. ``x`` must be real."""
    h = _hilbert(int(x.shape[-1]), x.device, x.dtype)
    return _fft.ifft(_fft.fft(x, routes) * h, routes)


def pll_harmonic(analytic: torch.Tensor, mult: int = 1,
                 part: str = "imag") -> torch.Tensor:
    """Unit-amplitude harmonic of an analytic signal's phase:
    ``Re(aᵐ)/|aᵐ|`` or ``Im(aᵐ)/|aᵐ|``."""
    a = analytic
    for _ in range(int(mult) - 1):
        a = a * analytic
    comp = a.real if part == "real" else a.imag
    return comp / torch.abs(a)

"""Pilot-tone harmonic synthesis; counterpart of
``radiocore_tpu/ops/analytic.py`` (``pll_harmonic``)."""

from __future__ import annotations

import torch


def pll_harmonic(analytic: torch.Tensor, mult: int = 1,
                 part: str = "imag") -> torch.Tensor:
    """Unit-amplitude harmonic of an analytic signal's phase:
    ``Re(aᵐ)/|aᵐ|`` or ``Im(aᵐ)/|aᵐ|``."""
    a = analytic
    for _ in range(int(mult) - 1):
        a = a * analytic
    comp = a.real if part == "real" else a.imag
    return comp / torch.abs(a)

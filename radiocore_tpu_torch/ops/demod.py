"""Quadrature (FM) demodulation; counterpart of
``radiocore_tpu/ops/demod.py``.

The wrapped phase step ``angle(x[n]·conj(x[n−1]))`` equals
``diff(unwrap(angle(x)))`` and needs no sequential unwrap.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def quadrature_demod(iq: torch.Tensor,
                     gain: Optional[float] = None) -> torch.Tensor:
    """Demodulate FM from complex baseband along the last axis.

    Same length as the input, first sample 0; default gain ``1/π``.

    A dead channel demodulates to 0 whatever the signs of its zeros: the
    product is formed as ``0 + x[n]·conj(x[n−1])`` in one pass, which
    turns a ``−0`` part into ``+0``, where ``angle(−0 + 0j)`` would be π
    (an extraction kernel's zeros come out signed).
    """
    d = torch.addcmul(iq.new_zeros(()), iq[..., 1:],
                      torch.conj(iq[..., :-1]))
    ph = torch.angle(d) * (1.0 / math.pi if gain is None else gain)
    return F.pad(ph, (1, 0))

"""Quadrature (FM) demodulation; counterpart of
``radiocore_tpu/ops/demod.py``.

The wrapped phase step ``angle(x[n]·conj(x[n−1]))`` equals
``diff(unwrap(angle(x)))`` and needs no sequential unwrap.
"""

from __future__ import annotations

from typing import Optional

import torch

from radiocore_tpu_torch.kernels.quad_demod import (quad_demod_plain,
                                                    quad_demod_rows)


def quadrature_demod(iq: torch.Tensor,
                     gain: Optional[float] = None) -> torch.Tensor:
    """Demodulate FM from complex baseband along the last axis.

    Same length as the input, first sample 0; default gain ``1/π``.

    A dead channel demodulates to 0 whatever the signs of its zeros: the
    product is formed as ``0 + x[n]·conj(x[n−1])`` in one pass, which
    turns a ``−0`` part into ``+0``, where ``angle(−0 + 0j)`` would be π
    (an extraction kernel's zeros come out signed).

    A CUDA tensor runs K-QDEMOD (``kernels/quad_demod``; complex64 only),
    a CPU tensor its plain version.
    """
    if iq.is_cuda:
        return quad_demod_rows(iq, gain)
    if iq.device.type != "cpu":
        raise ValueError(f"quadrature_demod: no kernel for {iq.device}")
    return quad_demod_plain(iq, gain)

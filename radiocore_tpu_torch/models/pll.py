"""Analytic-signal pilot tracker ("PLL"); counterpart of
``radiocore_tpu/models/pll.py``: not a feedback loop — ``step`` stores
the Hilbert analytic signal of the pilot; ``real`` and ``image`` give
unit-amplitude harmonics by raising it to an integer power. On a card the
analytic signal is captured once per input signature as a CUDA graph and
returns fresh tensors (``runtime/graphs``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from radiocore_tpu_torch.ops.analytic import analytic_signal, pll_harmonic
from radiocore_tpu_torch.runtime.graphs import compile_step
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.routes import Routes
from radiocore_tpu_torch.runtime.transfer import (to_device_c64,
                                                  to_device_f32)


class PLL:
    def __init__(self, cuda: bool = False, *,
                 device: Optional[torch.device | str] = None,
                 routes: Optional[Routes] = None):
        del cuda  # kept for the reference's signature; ``device`` decides
        self._device = resolve_device(device)
        self._analytic = compile_step(
            lambda x: analytic_signal(x, routes), self._device)
        self._baseline = None

    def step(self, input_sig) -> None:
        is_complex = (input_sig.is_complex()
                      if isinstance(input_sig, torch.Tensor)
                      else np.iscomplexobj(input_sig))
        put = to_device_c64 if is_complex else to_device_f32
        self._baseline = self._analytic(put(input_sig, self._device))

    def real(self, mult: float = 1.0) -> torch.Tensor:
        """Real part of the locked carrier at harmonic ``mult`` (cosine)."""
        return pll_harmonic(self._baseline, int(mult), "real")

    def image(self, mult: float = 1.0) -> torch.Tensor:
        """Imag part of the locked carrier at harmonic ``mult`` (sine)."""
        return pll_harmonic(self._baseline, int(mult), "imag")

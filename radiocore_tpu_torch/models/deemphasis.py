"""Streaming FM de-emphasis filter class; counterpart of
``radiocore_tpu/models/deemphasis.py``: the 51-tap FIR form of the
single-pole IIR, its state carried across calls and seeded at the
unit-step steady state. On a card the filter is captured once per input
signature as a CUDA graph and returns fresh tensors
(``runtime/graphs``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from radiocore_tpu_torch.ops.deemphasis import (deemphasis_apply,
                                                deemphasis_init)
from radiocore_tpu_torch.runtime.graphs import compile_step
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.routes import Routes
from radiocore_tpu_torch.runtime.transfer import (as_torch_dtype,
                                                  to_device_f32)


class Deemphasis:
    def __init__(self, input_size: Union[int, float], rate: float = 75e-6,
                 dtype: Union[str, torch.dtype] = "float32",
                 cuda: bool = False, *,
                 device: Optional[torch.device | str] = None,
                 routes: Optional[Routes] = None):
        del cuda  # kept for the reference's signature; ``device`` decides
        self._input_size = int(input_size)
        self._dtype = as_torch_dtype(dtype)
        self._device = resolve_device(device)
        taps, self._state = deemphasis_init(
            self._input_size, rate, dtype=self._dtype, device=self._device)
        self._run = compile_step(
            lambda x, hist: deemphasis_apply(x, taps, hist, routes),
            self._device)

    def run(self, input_sig) -> torch.Tensor:
        """Apply streaming de-emphasis to one chunk (state carried)."""
        if len(input_sig) != self._input_size:
            raise ValueError("input_sig size and input_size mismatch")
        x = to_device_f32(input_sig, self._device).to(self._dtype)
        y, self._state = self._run(x, self._state)
        return y

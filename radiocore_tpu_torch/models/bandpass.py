"""Zero-phase FIR bandpass filter class; counterpart of
``radiocore_tpu/models/bandpass.py``: taps by ``firwin(num_taps, [lo, hi],
pass_zero=False, window='hamm')`` with Hz normalized under the one-second
convention; ``run`` filters forward and backward like ``filtfilt``. On a
card the filter is captured once per input signature as a CUDA graph and
returns fresh tensors (``runtime/graphs``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops.fir import zero_phase_fir
from radiocore_tpu_torch.runtime.graphs import compile_step
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.routes import Routes
from radiocore_tpu_torch.runtime.transfer import (as_torch_dtype,
                                                  to_device_c64,
                                                  to_device_f32)


class Bandpass:
    def __init__(self, input_size: Union[int, float],
                 start_freq: Union[int, float],
                 stop_freq: Union[int, float],
                 dtype: Union[str, torch.dtype] = "float32",
                 num_taps: int = 61, window: str = "hamm",
                 cuda: bool = False, *,
                 device: Optional[torch.device | str] = None,
                 routes: Optional[Routes] = None):
        del cuda  # kept for the reference's signature; ``device`` decides
        self._input_size = int(input_size)
        self._dtype = as_torch_dtype(dtype)
        self._device = resolve_device(device)
        self._taps = taps = design.bandpass_taps(
            num_taps, float(start_freq), float(stop_freq), self._input_size,
            win=window)
        self._run = compile_step(
            lambda x: zero_phase_fir(x, taps, routes=routes), self._device)

    @property
    def taps(self) -> np.ndarray:
        """The designed FIR taps (host NumPy, for inspection and tests)."""
        return self._taps

    def run(self, input_sig) -> torch.Tensor:
        """Zero-phase bandpass of one chunk (scipy filtfilt edges)."""
        if len(input_sig) != self._input_size:
            raise ValueError("input_sig size and input_size mismatch")
        put = to_device_c64 if self._dtype.is_complex else to_device_f32
        x = put(input_sig, self._device).to(self._dtype)
        return self._run(x)

"""FFT-method resampler class; counterpart of
``radiocore_tpu/models/decimate.py``: ``resample(x, output_size,
window=fftshift(hamming(input_size)))``, any ratio, complex or real.
On a card the resample is captured once per input dtype as a CUDA graph
and returns fresh tensors (``runtime/graphs``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.consts import HostConst
from radiocore_tpu_torch.ops.resample import (real_resample_weights,
                                              resample_real,
                                              resample_spectrum)
from radiocore_tpu_torch.runtime.graphs import compile_step
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.routes import Routes
from radiocore_tpu_torch.runtime.transfer import (to_device_c64,
                                                  to_device_f32)


class Decimate:
    def __init__(self, input_size: Union[int, float],
                 output_size: Union[int, float], cuda: bool = False, *,
                 device: Optional[torch.device | str] = None,
                 routes: Optional[Routes] = None):
        del cuda  # kept for the reference's signature; ``device`` decides
        self._input_size = int(input_size)
        self._output_size = int(output_size)
        self._device = resolve_device(device)
        win = design.resample_window("hamm", self._input_size)
        c_win = HostConst(win.astype(np.float32))
        c_real = HostConst(real_resample_weights(
            self._input_size, self._output_size, win).astype(np.float32))
        num = self._output_size

        def resample(x: torch.Tensor) -> torch.Tensor:
            if x.is_complex():
                return resample_spectrum(
                    _fft.fft(x, routes) * c_win.on(x.device), num, routes)
            return resample_real(x, num, c_real.on(x.device), routes)

        self._run = compile_step(resample, self._device)

    def run(self, input_sig) -> torch.Tensor:
        """FFT-resample one chunk to the output rate (scipy semantics)."""
        if len(input_sig) != self._input_size:
            raise ValueError("input_sig size and input_size mismatch")
        is_complex = (input_sig.is_complex()
                      if isinstance(input_sig, torch.Tensor)
                      else np.iscomplexobj(input_sig))
        put = to_device_c64 if is_complex else to_device_f32
        return self._run(put(input_sig, self._device))

"""Generic FM quadrature demodulator; counterpart of
``radiocore_tpu/models/fm.py``: quadrature demod, then the windowed FFT
resample to the output rate. The reference's unused ``deemphasis``
constructor argument is kept for its signature."""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops.consts import HostConst
from radiocore_tpu_torch.ops.demod import quadrature_demod
from radiocore_tpu_torch.ops.resample import (real_resample_weights,
                                              resample_real)
from radiocore_tpu_torch.runtime.graphs import compile_step
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.routes import Routes
from radiocore_tpu_torch.runtime.transfer import to_device_c64, to_host


def make_fm_step(input_size: int, output_size: int,
                 routes: Optional[Routes] = None
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """FM step: ``iq (..., input_size) c64 → audio (..., output_size) f32``.

    Stateless. The spectral hamming window is applied even when the two
    sizes are equal, as the reference's internal resampler does.
    ``routes`` routes the resample's transforms (``ops/fft``).
    """
    input_size, output_size = int(input_size), int(output_size)
    win = design.resample_window("hamm", input_size)
    c_w = HostConst(real_resample_weights(input_size, output_size,
                                          win).astype(np.float32))

    def step(iq: torch.Tensor) -> torch.Tensor:
        demod = quadrature_demod(iq)
        return resample_real(demod, output_size, c_w.on(iq.device),
                             routes).to(torch.float32)

    return step


class FM:
    """Stateful wrapper with the reference ``run`` API; output ``(N, 1)``.
    Runs on ``device`` (the first CUDA device when None) through
    ``routes`` (None: the defaults). On a card its step is captured once
    per input signature as a CUDA graph and returns fresh tensors
    (``runtime/graphs``)."""

    def __init__(self, input_size: Union[int, float],
                 output_size: Union[int, float],
                 deemphasis: float = 75e-6, cuda: bool = False, *,
                 device: Optional[torch.device | str] = None,
                 routes: Optional[Routes] = None):
        del deemphasis, cuda  # kept for the reference's signature, unused
        self._input_size = int(input_size)
        self._output_size = int(output_size)
        self._device = resolve_device(device)
        self._step = compile_step(
            make_fm_step(self._input_size, self._output_size, routes),
            self._device)

    @property
    def channels(self) -> int:
        """Audio channel count (1: mono)."""
        return 1

    def run(self, input_sig, numpy_output: bool = True):
        """Demodulate one chunk: ``(output_size, 1)``, a NumPy array
        unless ``numpy_output=False``."""
        if len(input_sig) != self._input_size:
            raise ValueError("input_sig size and input_size mismatch")
        audio = self._step(to_device_c64(input_sig, self._device))[:, None]
        return to_host(audio) if numpy_output else audio

"""Mono broadcast-FM demodulator; counterpart of
``radiocore_tpu/models/mfm.py``: FM demod and decimation, streaming
de-emphasis, DC removal, clip at ±0.999."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from radiocore_tpu_torch.models.fm import make_fm_step
from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops.deemphasis import (deemphasis_apply,
                                                deemphasis_init)
from radiocore_tpu_torch.runtime.graphs import compile_step
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.routes import Routes
from radiocore_tpu_torch.runtime.transfer import to_device_c64, to_host

CLIP = 0.999

State = Dict[str, torch.Tensor]


def mfm_init_state(output_size: int, rate: float = 75e-6,
                   batch_shape: Tuple[int, ...] = (), *,
                   device: torch.device | str) -> State:
    """Initial de-emphasis history (per station when batched)."""
    _, hist = deemphasis_init(output_size, rate, batch_shape=batch_shape,
                              device=device)
    return {"deemph": hist}


def make_mfm_step(input_size: int, output_size: int,
                  deemphasis: float = 75e-6,
                  routes: Optional[Routes] = None
                  ) -> Callable[[torch.Tensor, State],
                                Tuple[torch.Tensor, State]]:
    """MFM step: ``(iq (..., input_size), state) → (audio
    (..., output_size), state)``; ``routes`` routes the transforms and
    the de-emphasis FIR."""
    fm = make_fm_step(input_size, output_size, routes)
    de_taps = design.deemphasis_taps(int(output_size), deemphasis)

    def step(iq: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
        audio, hist = deemphasis_apply(fm(iq), de_taps, state["deemph"],
                                       routes)
        audio = audio - torch.mean(audio, dim=-1, keepdim=True)
        audio = torch.clamp(audio, -CLIP, CLIP)
        return audio.to(torch.float32), {"deemph": hist}

    return step


class MFM:
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
        del cuda  # kept for the reference's signature; ``device`` decides
        self._input_size = int(input_size)
        self._output_size = int(output_size)
        self._device = resolve_device(device)
        self._step = compile_step(
            make_mfm_step(self._input_size, self._output_size, deemphasis,
                          routes), self._device)
        self._state = mfm_init_state(self._output_size, deemphasis,
                                     device=self._device)

    @property
    def channels(self) -> int:
        """Audio channel count (1: mono)."""
        return 1

    def run(self, input_sig, numpy_output: bool = True):
        """Demodulate one chunk, carrying the de-emphasis state across
        calls."""
        if len(input_sig) != self._input_size:
            raise ValueError("input_sig size and input_size mismatch")
        iq = to_device_c64(input_sig, self._device)
        audio, self._state = self._step(iq, self._state)
        audio = audio[:, None]
        return to_host(audio) if numpy_output else audio

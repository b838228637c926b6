"""Streaming FM de-emphasis as a stateful FIR; counterpart of
``radiocore_tpu/ops/deemphasis.py``. The state is the raw trailing input
history, carried between one-second chunks."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops.fir import fir_stream
from radiocore_tpu_torch.runtime.routes import Routes


def deemphasis_init(input_size: int, rate: float = 75e-6,
                    num_taps: int = 51,
                    batch_shape: Tuple[int, ...] = (),
                    dtype: torch.dtype = torch.float32, *,
                    device: torch.device | str) -> Tuple[np.ndarray,
                                                         torch.Tensor]:
    """Taps and the initial carried state: a history of ones, the steady
    state the reference seeds via ``lfilter_zi``."""
    taps = design.deemphasis_taps(input_size, rate, num_taps)
    hist = torch.ones(tuple(batch_shape) + (num_taps - 1,),
                      dtype=dtype, device=device)
    return taps, hist


def deemphasis_apply(x: torch.Tensor, taps, history: torch.Tensor,
                     routes: Optional[Routes] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply de-emphasis to one chunk; returns ``(audio, new_history)``.
    The FIR's slot follows ``routes.fir_impl`` (``ops.fir.fir_route``)."""
    return fir_stream(x, taps, history, routes)

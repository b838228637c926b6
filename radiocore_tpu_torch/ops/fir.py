"""Causal and streaming FIR filtering; counterpart of the main-path part
of ``radiocore_tpu/ops/fir.py`` (``fir_causal``, ``fir_stream``).

All functions take arbitrary leading batch dimensions and work on the
last axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import fir as kfir

KERNEL_MIN_LEN = 16384


def _use_kernel(x: torch.Tensor, taps) -> bool:
    """The JAX routing rule (``ops/fir.py`` impl='auto'): long real
    float32 signals with host NumPy taps go to the kernel, on CUDA."""
    return (x.is_cuda and x.dtype == torch.float32
            and x.shape[-1] >= KERNEL_MIN_LEN
            and isinstance(taps, np.ndarray))


def fir_causal(x: torch.Tensor, taps,
               history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal FIR ``y[n] = Σ_k b[k]·x[n−k]`` with explicit input history
    (the ``num_taps−1`` samples before ``x``; zeros by default — as
    ``scipy.signal.lfilter(b, 1, x)``)."""
    if _use_kernel(x, taps):
        return kfir.fir_causal_rows(x, taps, history)
    return kfir.fir_causal_plain(x, taps, history)


def fir_stream(x: torch.Tensor, taps,
               history: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal FIR: returns ``(y, new_history)``, the carried
    state being the raw trailing input samples (``lfilter`` with ``zi``)."""
    t = int(np.shape(taps)[0])
    y = fir_causal(x, taps, history=history)
    if t - 1 <= x.shape[-1]:
        new_history = x[..., x.shape[-1] - (t - 1):]
    else:
        new_history = torch.cat([history.to(x.dtype), x],
                                dim=-1)[..., -(t - 1):]
    return y, new_history

"""Critically-sampled polyphase filterbank (PFB) analysis channelizer;
counterpart of ``radiocore_tpu/ops/pfb.py``.

A length ``M·P`` prototype lowpass folded into ``M`` branches, a
depthwise branch convolution over frames of ``M`` samples, and an M-point
FFT per output frame: all ``M`` channels at once, uniform spacing
``fs/M``. Streaming state is the trailing ``(P−1)·M`` input samples.

Convention: channel k is centred at ``k·fs/M`` (wrapping negatives),
output rate ``fs/M`` per channel, unit passband gain.

The JAX package lowers the branch convolution to XLA elementwise code,
not to a Pallas kernel, so plain PyTorch is the port here: ``P`` shifted
multiply-adds over the frame matrix, in float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from scipy import signal as _sig

from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.consts import device_array
from radiocore_tpu_torch.runtime.routes import Routes
from radiocore_tpu_torch.runtime.platform import resolve_device


def pfb_taps(n_channels: int, taps_per_branch: int = 8,
             cutoff_scale: float = 1.0, window: str = "hamming") -> np.ndarray:
    """Prototype lowpass for an M-channel PFB (length ``M·P``), unit DC
    gain, designed on the host."""
    m, p = int(n_channels), int(taps_per_branch)
    h = _sig.firwin(m * p, cutoff_scale / m, window=window)
    return (h / h.sum()).astype(np.float64)


def pfb_init(n_channels: int, taps_per_branch: int = 8,
             batch_shape: Tuple[int, ...] = (),
             dtype: torch.dtype = torch.complex64, *,
             device: Optional[torch.device | str] = None) -> torch.Tensor:
    """Initial streaming history: the ``(P−1)·M`` samples before the
    chunk, zeros on ``device`` (the card when None)."""
    m, p = int(n_channels), int(taps_per_branch)
    return torch.zeros(tuple(batch_shape) + ((p - 1) * m,), dtype=dtype,
                       device=resolve_device(device))


def _branch_conv(z: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Depthwise conv over frames: z (..., S, M), kernels (M, P) →
    (..., S−P+1, M); ``out[t, m] = Σ_q z[t+q, m]·kernels[m, q]``, one
    shifted multiply-add a tap (real taps scale I and Q alike)."""
    p = kernels.shape[-1]
    t_out = z.shape[-2] - p + 1
    acc = z[..., 0:t_out, :] * kernels[:, 0]
    for q in range(1, p):
        acc = acc + z[..., q:q + t_out, :] * kernels[:, q]
    return acc


def pfb_channelize(x: torch.Tensor, taps: np.ndarray, n_channels: int,
                   history: Optional[torch.Tensor] = None,
                   routes: Optional[Routes] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channelize ``x`` (..., N) into ``(..., N/M, M)`` plus the new
    history.

    Causal streaming form: frame t of channel k is
    ``Σ_m e^{-2πi·m·k/M} Σ_p h[p·M+m]·x[(t−p)·M+m]`` with ``x`` read
    through the carried history, so chunks stitch seamlessly.
    """
    m = int(n_channels)
    taps = np.asarray(taps, dtype=np.float64)
    if len(taps) % m:
        raise ValueError("taps length must be a multiple of n_channels")
    p = len(taps) // m
    n = x.shape[-1]
    if n % m:
        raise ValueError(f"chunk ({n}) must divide by n_channels ({m})")

    if history is None:
        history = pfb_init(m, p, tuple(x.shape[:-1]), x.dtype,
                           device=x.device)
    xh = torch.cat([history.to(x.dtype), x], dim=-1)
    new_history = xh[..., xh.shape[-1] - (p - 1) * m:]

    z = xh.reshape(tuple(x.shape[:-1]) + (-1, m))     # (..., T+P−1, M)
    # Branch kernels: reversed-in-p taps per branch (correlation form),
    # float32 as in the reference.
    kernels = np.ascontiguousarray(taps.reshape(p, m).T[:, ::-1],
                                   dtype=np.float32)
    kern = device_array(kernels, x.device, x.real.dtype)
    y = _branch_conv(z, kern).to(x.dtype)

    # M-point DFT over the branch axis picks the channel centres k·fs/M
    # (unit passband gain: the taps are normalised to Σh = 1).
    return _fft.fft(y, routes), new_history

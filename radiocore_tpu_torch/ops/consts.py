"""Host-designed constants (windows, weights, phasors, taps), copied once
to each device that asks for them.

The JAX package bakes such NumPy arrays into its jitted programs; in
eager PyTorch a fresh host→device copy per call would stall the stream,
and inside a CUDA graph's capture it is not allowed at all, so each
constant keeps one copy per device. Both forms hand their tensors out
through ``runtime.graphs.hold``: a captured graph keeps what it reads.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from radiocore_tpu_torch.runtime.graphs import device_cache, hold


class HostConst:
    """A NumPy array with cached per-device tensor copies."""

    def __init__(self, array: np.ndarray) -> None:
        self.array = np.ascontiguousarray(array)
        self._copies: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._copies.get(device)
        if t is None:
            t = torch.from_numpy(self.array).to(device)
            self._copies[device] = t
        return hold(t)


@device_cache(maxsize=64)
def _device_array(data: bytes, np_dtype: str, shape: tuple,
                  device: torch.device,
                  dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.frombuffer(data, dtype=np.dtype(np_dtype)).reshape(shape)
    return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)


def device_array(array, device: torch.device | str,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``array`` on ``device`` (as ``dtype``, if given), copied there once
    per contents, device and dtype: a later call with equal contents
    makes no host→device copy. The tensor is shared: read it only."""
    a = np.ascontiguousarray(array)
    return _device_array(a.tobytes(), a.dtype.str, a.shape,
                         torch.device(device), dtype)

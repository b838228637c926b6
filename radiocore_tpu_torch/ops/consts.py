"""Host-designed constants (windows, weights, phasors), copied once to
each device that asks for them.

The JAX package bakes such NumPy arrays into its jitted programs; in
eager PyTorch a fresh host→device copy per call would stall the stream,
so each constant keeps one copy per device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


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
        return t

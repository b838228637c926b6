"""Streaming-state transfer and checkpoints for the port.

The state is a flat dict of tensors with the JAX package's keys
(``deemph_l``, ``deemph_r``). :func:`load_state` reads the npz files the
JAX package's ``save_state`` writes (``radiocore_tpu/runtime/
checkpoint.py``), whose keys are the tree paths of the dict entries
(``"['deemph_l']"``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

State = Dict[str, torch.Tensor]


def _npz_key(name: str) -> str:
    return f"['{name}']"


def state_from_numpy(state: Mapping[str, np.ndarray],
                     device: torch.device | str) -> State:
    """Numpy (e.g. JAX) state arrays → tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in state.items()}


def state_to_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors on any device → numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def load_state(path: str, like: Mapping[str, torch.Tensor]) -> State:
    """Load a state saved by the JAX package's ``save_state``.

    ``like`` gives the keys, shapes, dtypes and devices (e.g. a freshly
    initialized state); a missing entry or a shape mismatch raises.
    """
    out = {}
    with np.load(path) as data:
        for name, ref in like.items():
            key = _npz_key(name)
            if key not in data:
                raise KeyError(f"checkpoint missing state entry {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint entry {key!r} shape "
                                 f"{arr.shape} != {tuple(ref.shape)}")
            out[name] = torch.from_numpy(arr).to(device=ref.device,
                                                 dtype=ref.dtype)
    return out

"""Host ↔ device copies for the model classes; counterpart of the three
entry points of ``radiocore_tpu/runtime/transfer.py`` (``to_device_c64``,
``to_device_f32``, ``to_host``). Plain copies to and from a named device:
a NumPy array, a list or a tensor goes in, ``to_host`` gives a NumPy
array.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch


def as_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A ``torch.dtype`` from itself or from its name (``"float32"``, the
    way the reference's classes spell their ``dtype`` argument)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


def _put(x, dtype: torch.dtype, device: torch.device | str) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device,
                                                        dtype=dtype)


def to_device_c64(x, device: torch.device | str) -> torch.Tensor:
    """``x`` on ``device`` as complex64 (a real input gets a zero
    imaginary part)."""
    return _put(x, torch.complex64, device)


def to_device_f32(x, device: torch.device | str) -> torch.Tensor:
    """A real ``x`` on ``device`` as float32."""
    return _put(x, torch.float32, device)


def to_host(x) -> np.ndarray:
    """``x`` (a tensor on any device, or anything NumPy takes) as a NumPy
    array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""Platform probing for the port: the CUDA counterpart of
``radiocore_tpu/runtime/platform.py`` (``has_tpu``)."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import torch


def has_cuda() -> bool:
    """True when PyTorch sees a CUDA device. Never raises."""
    return torch.cuda.is_available()


def default_device() -> torch.device:
    """The first CUDA device. Without one it raises: the port's entry
    points run on a card unless the caller names the CPU."""
    if not has_cuda():
        raise RuntimeError(
            "radiocore_tpu_torch: no CUDA device (torch.cuda.is_available() "
            "is False); pass device='cpu' to run on the CPU")
    return torch.device("cuda", 0)


def resolve_device(device: Optional[torch.device | str] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; :func:`default_device` for None."""
    return default_device() if device is None else torch.device(device)


def nvidia_smi_name_power() -> Optional[str]:
    """``name, power.limit`` of the cards as ``nvidia-smi`` reports them,
    or None where ``nvidia-smi`` is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def platform_summary() -> dict:
    """Structured summary of the visible devices."""
    cuda = has_cuda()
    return {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "has_cuda": cuda,
        "nvidia_smi": nvidia_smi_name_power() if cuda else None,
    }

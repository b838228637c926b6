"""Platform probing and distributed start-up for the port: the CUDA
counterpart of ``radiocore_tpu/runtime/platform.py`` (``has_tpu``,
``initialize_multihost``)."""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

import torch
import torch.distributed as dist


def has_cuda() -> bool:
    """True when PyTorch sees a CUDA device. Never raises."""
    return torch.cuda.is_available()


def HasCuda() -> bool:  # noqa: N802 - parity alias with the reference
    """Alias of :func:`has_cuda` with the reference's name
    (``radiocore_tpu/runtime/platform.py:35``)."""
    return has_cuda()


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
    """Structured summary of the visible devices and of this process's
    place in the ``torch.distributed`` world (one process, index 0, when
    no group is initialized)."""
    cuda = has_cuda()
    world = dist.is_available() and dist.is_initialized()
    return {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "process_index": dist.get_rank() if world else 0,
        "process_count": dist.get_world_size() if world else 1,
        "has_cuda": cuda,
        "nvidia_smi": nvidia_smi_name_power() if cuda else None,
    }


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: Optional[str] = None) -> None:
    """Join this process to a ``torch.distributed`` world: the
    counterpart of ``jax.distributed.initialize`` in the reference.

    ``coordinator_address`` is ``host:port`` (read as ``tcp://host:port``)
    or a full ``init_method`` URL such as ``file:///path``; every process
    gives the same one, with the world size ``num_processes`` and its own
    ``process_id``. ``backend=None`` is ``nccl`` where a CUDA device is
    present and ``gloo`` otherwise; a world of CPU tensors on a machine
    with a card, or several ranks on one card (NCCL refuses two ranks on
    one device), says ``backend="gloo"``. Under ``nccl`` each process
    takes the card ``process_id % device_count`` as its current device.

    A no-op when the world is already initialized, or when no
    coordinator is given (one process).
    """
    if dist.is_initialized() or coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize_multihost: a coordinator needs "
                         "num_processes and process_id")
    if backend is None:
        backend = "nccl" if has_cuda() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id))

"""FFTs along the last axis, routed by device and size.

Counterpart of ``radiocore_tpu/ops/fft.py``. Power-of-two transforms of
at least :data:`KERNEL_MIN` points on a CUDA tensor go to K-FFT
(``kernels/fft_rows.py``), as the JAX package sends them to its Pallas
kernel on a TPU (``_use_pallas``); everything else is ``torch.fft``,
which handles every size, so the JAX planner's native-FFT probe and
four-step fallback have no counterpart here.
"""

from __future__ import annotations

import torch

from radiocore_tpu_torch.kernels import fft_rows

KERNEL_MIN = 1 << 24


def _use_kernel(x: torch.Tensor) -> bool:
    n = int(x.shape[-1])
    return x.is_cuda and (n & (n - 1)) == 0 and n >= KERNEL_MIN


def fft(x: torch.Tensor) -> torch.Tensor:
    """Forward FFT along the last axis."""
    if not x.is_complex():
        x = x.to(torch.complex64)
    if _use_kernel(x):
        return fft_rows.fft_large_pow2(x.contiguous(), -1.0)
    return torch.fft.fft(x, dim=-1)


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Inverse FFT along the last axis (normalized)."""
    if _use_kernel(x):
        return fft_rows.fft_large_pow2(x.contiguous(), +1.0) / x.shape[-1]
    return torch.fft.ifft(x, dim=-1)


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Real-input FFT along the last axis → n//2+1 bins."""
    return torch.fft.rfft(x, dim=-1)


def irfft(X: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse real FFT along the last axis to length ``n``."""
    return torch.fft.irfft(X, n=int(n), dim=-1)

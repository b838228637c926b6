"""FFTs along the last axis, routed by device and size.

Counterpart of ``radiocore_tpu/ops/fft.py``. On a CUDA tensor,
power-of-two transforms of at least :data:`KERNEL_MIN` points go to
K-FFT (``kernels/fft_rows.py``), as the JAX package sends them to its
Pallas kernel on a TPU (``_use_pallas``), and sizes ``a·2^k`` (a ≤ 128,
not a power of two) of at least :data:`MIXED_MIN` points go to K-MIXED
(``kernels/fft_mixed.py``), as ``_use_mixed`` sends them to
``fft_large_mixed_pallas``. Everything else is ``torch.fft``, which
handles every size, so the JAX planner's native-FFT probe and four-step
fallback have no counterpart here. The kernels take complex64 only: the
route is chosen by dtype as well as size, so a complex128 tensor goes to
``torch.fft`` on either device.
"""

from __future__ import annotations

import torch

from radiocore_tpu_torch.kernels import fft_mixed, fft_rows

KERNEL_MIN = 1 << 24
MIXED_MIN = 1 << 23


def route_name(n: int, dtype: torch.dtype, is_cuda: bool) -> str:
    """The slot a transform of ``n`` points takes: ``'rows'`` (K-FFT),
    ``'mixed'`` (K-MIXED) or ``'torch'`` (``torch.fft``)."""
    n = int(n)
    if not is_cuda or dtype != torch.complex64:
        return "torch"
    if (n & (n - 1)) == 0:
        return "rows" if n >= KERNEL_MIN else "torch"
    if n >= MIXED_MIN and fft_mixed.mixed_split(n) is not None:
        return "mixed"
    return "torch"


def _route(x: torch.Tensor, sign: float):
    """The kernel's result for ``x``, or None where torch.fft serves."""
    name = route_name(x.shape[-1], x.dtype, x.is_cuda)
    if name == "rows":
        return fft_rows.fft_large_pow2(x.contiguous(), sign)
    if name == "mixed":
        return fft_mixed.fft_large_mixed(x.contiguous(), sign)
    return None


def fft(x: torch.Tensor) -> torch.Tensor:
    """Forward FFT along the last axis."""
    if not x.is_complex():
        x = x.to(torch.complex128 if x.dtype == torch.float64
                 else torch.complex64)
    y = _route(x, -1.0)
    return torch.fft.fft(x, dim=-1) if y is None else y


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Inverse FFT along the last axis (normalized)."""
    y = _route(x, +1.0)
    return torch.fft.ifft(x, dim=-1) if y is None else y / x.shape[-1]


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Real-input FFT along the last axis → n//2+1 bins."""
    return torch.fft.rfft(x, dim=-1)


def irfft(X: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse real FFT along the last axis to length ``n``."""
    return torch.fft.irfft(X, n=int(n), dim=-1)

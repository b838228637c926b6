"""FFTs along the last axis, routed by device, dtype, size and
:class:`~radiocore_tpu_torch.runtime.routes.Routes`.

Counterpart of ``radiocore_tpu/ops/fft.py``. On a CUDA tensor
(:func:`route_name`), power-of-two transforms of at least
``routes.fft_kernel_min`` points go to K-FFT (``kernels/fft_rows.py``),
as the JAX package sends them to its Pallas kernel on a TPU
(``_use_pallas``): rows of ``MIN_ROW``–``MAX_ROW`` points to
``fft_pow2`` (the inverse divides by n, as ``ifft_pow2`` does), longer
ones to ``fft_large_pow2``, real transforms to ``rfft_pow2`` and
``irfft_pow2`` when n/2 is a row. Sizes ``a·2^k`` (a ≤ 128, not a power
of two) of at least ``routes.fft_mixed_min`` go to K-MIXED
(``kernels/fft_mixed.py``), as ``_use_mixed`` sends them to
``fft_large_mixed_pallas``. Other sizes of at least
``routes.fft_mixed_min`` that are not powers of two and whose
``band_split`` exists (``a·b`` with both sides' chains built in: the
10^7-point band, and 3200²) go to K-BANDFFT (``kernels/fft_band.py``),
two passes over device memory; the JAX package leaves them to XLA. The kernels take
complex64 (float32 for the rfft) only, so a complex128 tensor never
reaches them.

What no kernel takes goes to ``torch.fft``, which handles every size, so
the JAX planner's native-FFT probe and its ``set_policy`` have no
counterpart here. :func:`fft_decomposed` keeps one four-step level for
the extraction's ``extract_ifft="fourstep"``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import fft_band, fft_mixed, fft_rows
from radiocore_tpu_torch.runtime.graphs import device_cache
from radiocore_tpu_torch.runtime.routes import Routes, at_least, resolve

# The dtype each kind of transform's kernel takes.
_KERNEL_DTYPE = {"fft": torch.complex64, "rfft": torch.float32,
                 "irfft": torch.complex64}


def route_name(n: int, dtype: torch.dtype, is_cuda: bool,
               routes: Optional[Routes] = None, *, op: str = "fft",
               bins: Optional[int] = None) -> str:
    """The slot a transform of ``n`` points takes.

    ``op`` is ``"fft"`` (complex, either direction), ``"rfft"`` (``dtype``
    is the real input's) or ``"irfft"`` (``bins`` is the input's bin
    count; the kernel takes exactly ``n//2 + 1``). Returns ``"rows"``
    (K-FFT: ``fft_pow2``, or ``fft_large_pow2`` above ``MAX_ROW``; for
    ``rfft``/``irfft`` ``rfft_pow2``/``irfft_pow2``), ``"mixed"``
    (K-MIXED), ``"band"`` (K-BANDFFT: a complex transform that K-MIXED
    does not take, of a size with a ``band_split``) or ``"torch"``.
    """
    r = resolve(routes)
    n = int(n)
    pow2 = n > 0 and (n & (n - 1)) == 0
    if is_cuda and dtype == _KERNEL_DTYPE[op]:
        if pow2 and at_least(n, r.fft_kernel_min):
            if op == "fft" and n >= fft_rows.MIN_ROW:
                return "rows"
            half_row = fft_rows.MIN_ROW <= n // 2 <= fft_rows.MAX_ROW
            if (op != "fft" and half_row
                    and (op == "rfft" or bins == n // 2 + 1)):
                return "rows"
        if op == "fft" and not pow2 and at_least(n, r.fft_mixed_min):
            if fft_mixed.mixed_split(n) is not None:
                return "mixed"
            if fft_band.band_split(n) is not None:
                return "band"
    return "torch"


def _as_complex(x: torch.Tensor) -> torch.Tensor:
    if x.is_complex():
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64
                else torch.complex64)


def _fft_rec(x: torch.Tensor, sign: float, r: Routes) -> torch.Tensor:
    """Unnormalized DFT (sign −1 forward, +1 backward) of complex ``x``."""
    n = int(x.shape[-1])
    name = route_name(n, x.dtype, x.is_cuda, r)
    if name == "rows":
        return fft_rows.fft_large_pow2(x.contiguous(), sign)
    if name == "mixed":
        return fft_mixed.fft_large_mixed(x.contiguous(), sign)
    if name == "band":
        return fft_band.fft_band(x.contiguous(), sign)
    if sign < 0:
        return torch.fft.fft(x, dim=-1)
    return torch.fft.ifft(x, dim=-1, norm="forward")


def _split(n: int) -> Tuple[int, int]:
    """``n = a·b``, a ≤ b, as balanced as the factorization allows (the
    reference's ``_split``)."""
    factors, m, d = [], n, 2
    while d * d <= m:
        while m % d == 0:
            factors.append(d)
            m //= d
        d += 1
    if m > 1:
        factors.append(m)
    factors.sort(reverse=True)
    a = 1
    for f in factors:
        if a * f <= int(np.sqrt(n)) + 1:
            a *= f
    if a == 1:
        a = factors[-1]
    return a, n // a


@device_cache(maxsize=32)
def _twiddle(n1: int, n2: int, sign: float, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """``exp(sign·2πi·k1·j/n)`` as (n1, n2): the angle from ``k1·j mod n``
    in integers, evaluated in float64 and rounded once to ``dtype``."""
    n = n1 * n2
    k1 = torch.arange(n1, dtype=torch.int64, device=device)
    j = torch.arange(n2, dtype=torch.int64, device=device)
    ang = (k1[:, None] * j[None, :] % n).to(torch.float64) * (
        sign * 2 * np.pi / n)
    return torch.polar(torch.ones_like(ang), ang).to(dtype)


def _four_step(x: torch.Tensor, sign: float, r: Routes) -> torch.Tensor:
    """One four-step level: column DFTs, twiddle, row DFTs, transpose;
    both sets of sub-transforms through the routes."""
    n = int(x.shape[-1])
    n1, n2 = _split(n)
    if n1 == 1 or n2 == 1:
        # A prime: no split, the library takes it.
        return torch.fft.fft(x, dim=-1) if sign < 0 else torch.fft.ifft(
            x, dim=-1, norm="forward")
    lead = x.shape[:-1]
    a = x.reshape(lead + (n1, n2))
    z = _fft_rec(a.transpose(-1, -2), sign, r)          # (..., n2, n1)
    z = z.transpose(-1, -2) * _twiddle(n1, n2, sign, x.dtype, x.device)
    xm = _fft_rec(z, sign, r)                            # (..., n1, n2)
    # Output index k = k1 + n1·k2: k2 becomes the outer axis.
    return xm.transpose(-1, -2).reshape(lead + (n,))


def fft_decomposed(x: torch.Tensor, sign: float = -1.0,
                   routes: Optional[Routes] = None) -> torch.Tensor:
    """One four-step level (unnormalized; ``sign`` −1 forward, +1
    backward); its sub-transforms go through the routes. The reference's
    escape hatch for the extraction's inverse
    (``RADIOCORE_TPU_EXTRACT_IFFT=fourstep``)."""
    return _four_step(_as_complex(x), sign, resolve(routes))


def ifft_decomposed(x: torch.Tensor,
                    routes: Optional[Routes] = None) -> torch.Tensor:
    """Inverse counterpart of :func:`fft_decomposed` (normalized)."""
    return fft_decomposed(x, +1.0, routes) / x.shape[-1]


def fft(x: torch.Tensor, routes: Optional[Routes] = None) -> torch.Tensor:
    """Forward FFT along the last axis."""
    return _fft_rec(_as_complex(x), -1.0, resolve(routes))


def ifft_unscaled(x: torch.Tensor,
                  routes: Optional[Routes] = None) -> torch.Tensor:
    """The backward DFT without its 1/n, on :func:`ifft`'s route: for a
    caller that folded the scale into its input, which saves the
    normalization's pass over the result (``torch.fft.ifft`` runs it as
    a kernel of its own on the card)."""
    return _fft_rec(_as_complex(x), +1.0, resolve(routes))


def ifft(x: torch.Tensor, routes: Optional[Routes] = None) -> torch.Tensor:
    """Inverse FFT along the last axis (normalized)."""
    r = resolve(routes)
    if route_name(x.shape[-1], x.dtype, x.is_cuda, r) == "torch":
        return torch.fft.ifft(x, dim=-1)
    return _fft_rec(_as_complex(x), +1.0, r) / x.shape[-1]


def rfft(x: torch.Tensor, routes: Optional[Routes] = None) -> torch.Tensor:
    """Real-input FFT along the last axis → n//2+1 bins."""
    r = resolve(routes)
    if route_name(x.shape[-1], x.dtype, x.is_cuda, r, op="rfft") == "rows":
        return fft_rows.rfft_pow2(x.contiguous())
    return torch.fft.rfft(x, dim=-1)


def irfft(X: torch.Tensor, n: int,
          routes: Optional[Routes] = None) -> torch.Tensor:
    """Inverse real FFT along the last axis to length ``n``."""
    r = resolve(routes)
    n = int(n)
    if route_name(n, X.dtype, X.is_cuda, r, op="irfft",
                  bins=X.shape[-1]) == "rows":
        return fft_rows.irfft_pow2(X.contiguous(), n)
    return torch.fft.irfft(X, n=n, dim=-1)

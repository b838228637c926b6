"""FIR filtering: causal, streaming, overlap-save and zero-phase;
counterpart of ``radiocore_tpu/ops/fir.py``.

All functions take arbitrary leading batch dimensions and work on the
last axis. :func:`fir_causal` chooses its slot from the tensor's device,
dtype and length, the tap count and, for ``impl="auto"``,
``routes.fir_impl`` *before* anything runs (:func:`fir_route`): K-FIR
(``kernels/fir.py``), its plain version, or the overlap-save FFT form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from radiocore_tpu_torch.kernels import fir as kfir
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.runtime.graphs import device_cache
from radiocore_tpu_torch.runtime.routes import Routes, resolve

KERNEL_MIN_LEN = 16384

# ``impl`` spellings; the JAX package's own ('pallas', 'conv') are taken
# too, so that a caller written for it keeps working.
_IMPL = {"auto": "auto", "kernel": "kernel", "pallas": "kernel",
         "plain": "plain", "conv": "plain", "fft": "fft"}


def _use_kernel(x: torch.Tensor, taps) -> bool:
    """The JAX routing rule (``ops/fir.py`` impl='auto' with
    ``RADIOCORE_TPU_FIR_IMPL=pallas``): long real float32 signals with
    host NumPy taps go to the kernel, on CUDA."""
    return (x.is_cuda and x.dtype == torch.float32
            and x.shape[-1] >= KERNEL_MIN_LEN
            and isinstance(taps, np.ndarray))


def _auto_slot(x: torch.Tensor, taps, fir_impl: str) -> str:
    """``impl='auto'`` under ``routes.fir_impl``, by the reference's rule:
    ``pallas`` is the kernel where :func:`_use_kernel` allows it, ``fft``
    overlap-save from :data:`KERNEL_MIN_LEN` samples, and each is the
    plain version otherwise, as ``conv`` always is."""
    if fir_impl == "pallas" and _use_kernel(x, taps):
        return "kernel"
    if fir_impl == "fft" and x.shape[-1] >= KERNEL_MIN_LEN:
        return "fft"
    return "plain"


def fir_route(x: torch.Tensor, taps, impl: str = "auto",
              routes: Optional[Routes] = None) -> str:
    """The slot ``fir_causal(x, taps, impl=impl, routes=routes)`` takes:
    ``'kernel'`` (K-FIR; its plain version for a CPU tensor), ``'plain'``
    or ``'fft'`` (:func:`fir_overlap_save`). The kernel takes real float32
    signals and at most ``kernels.fir.MAX_TAPS`` taps: longer tap sets go
    to overlap-save, other dtypes to the plain version."""
    try:
        slot = _IMPL[impl]
    except KeyError:
        raise ValueError(f"impl={impl!r}: expected one of "
                         f"{sorted(_IMPL)}") from None
    if slot == "auto":
        slot = _auto_slot(x, taps, resolve(routes).fir_impl)
    if slot == "kernel":
        if x.dtype != torch.float32:
            return "plain"
        if int(np.shape(taps)[0]) > kfir.MAX_TAPS:
            return "fft"
    return slot


def fir_causal(x: torch.Tensor, taps,
               history: Optional[torch.Tensor] = None,
               impl: str = "auto",
               routes: Optional[Routes] = None) -> torch.Tensor:
    """Causal FIR ``y[n] = Σ_k b[k]·x[n−k]`` with explicit input history
    (the ``num_taps−1`` samples before ``x``; zeros by default — as
    ``scipy.signal.lfilter(b, 1, x)``).

    ``impl``: ``'kernel'`` (K-FIR on a CUDA tensor, its plain version on
    the CPU), ``'plain'`` (shift-and-add in ``x``'s dtype), ``'fft'``
    (overlap-save) or ``'auto'``: ``routes.fir_impl`` decides, by the
    reference's rule; under the default (``pallas``) the kernel for long
    real float32 CUDA signals with host NumPy taps, the plain version
    otherwise. See :func:`fir_route`.
    """
    slot = fir_route(x, taps, impl, routes)
    if slot == "fft":
        return fir_overlap_save(x, taps, history=history, routes=routes)
    if slot == "kernel":
        if history is not None and history.dtype != torch.float32:
            history = history.to(torch.float32)
        return kfir.fir_causal_rows(x, taps, history)
    return kfir.fir_causal_plain(x, taps, history)


def fir_stream(x: torch.Tensor, taps, history: torch.Tensor,
               routes: Optional[Routes] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming causal FIR: returns ``(y, new_history)``, the carried
    state being the raw trailing input samples (``lfilter`` with ``zi``)."""
    t = int(np.shape(taps)[0])
    y = fir_causal(x, taps, history=history, routes=routes)
    if t - 1 <= x.shape[-1]:
        new_history = x[..., x.shape[-1] - (t - 1):]
    else:
        new_history = torch.cat([history.to(x.dtype), x],
                                dim=-1)[..., -(t - 1):]
    return y, new_history


@device_cache(maxsize=32)
def _tap_spectrum(taps: bytes, nfft: int, onesided: bool,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The ``nfft``-point spectrum of the float64 ``taps`` (its rfft when
    ``onesided``) on ``device``, computed and copied there once."""
    t = np.frombuffer(taps, dtype=np.float64)
    h = np.fft.rfft(t, nfft) if onesided else np.fft.fft(t, nfft)
    return torch.from_numpy(h).to(device=device, dtype=dtype)


def fir_overlap_save(x: torch.Tensor, taps,
                     history: Optional[torch.Tensor] = None,
                     block: int = 1 << 15,
                     routes: Optional[Routes] = None) -> torch.Tensor:
    """Causal FIR via FFT overlap-save: the output of :func:`fir_causal`
    at a cost independent of the tap count. Blocks of ``block`` samples
    are filtered with an FFT of ``2^k ≥ block + T − 1`` points against a
    precomputed tap spectrum; ``history`` works as in :func:`fir_stream`.
    """
    taps_np = np.asarray(taps, dtype=np.float64)
    t = len(taps_np)
    n = int(x.shape[-1])
    block = int(block)
    if block < t:
        raise ValueError(f"block ({block}) must be >= num_taps ({t})")
    nfft = 1
    while nfft < block + t - 1:
        nfft *= 2

    if history is None:
        history = x.new_zeros(x.shape[:-1] + (t - 1,))
    n_blocks = -(-n // block)
    # Pad so that the body reshape and the last block's (t-1)-tail exist.
    pad = n_blocks * block + (t - 1) - (n + t - 1)
    xp = F.pad(torch.cat([history.to(x.dtype), x], dim=-1), (0, pad))

    # Segment b = xp[b·block : b·block + block + t − 1], from one reshape
    # and the heads of the following blocks.
    body = xp[..., :n_blocks * block].reshape(
        xp.shape[:-1] + (n_blocks, block))
    tail_last = xp[..., n_blocks * block:n_blocks * block + t - 1]
    tails = torch.cat([body[..., 1:, :t - 1], tail_last[..., None, :]],
                      dim=-2)
    segs = F.pad(torch.cat([body, tails], dim=-1),
                 (0, nfft - (block + t - 1)))

    double = x.real.dtype == torch.float64
    cdtype = torch.complex128 if double else torch.complex64
    hs = _tap_spectrum(taps_np.tobytes(), nfft, not x.is_complex(), cdtype,
                       x.device)
    if x.is_complex():
        y = _fft.ifft(_fft.fft(segs, routes) * hs, routes).to(x.dtype)
    else:
        y = _fft.irfft(_fft.rfft(segs, routes) * hs, nfft,
                       routes).to(x.dtype)
    # Valid region of each block: samples t-1 .. t-1+block-1.
    y = y[..., t - 1:t - 1 + block]
    return y.reshape(x.shape[:-1] + (n_blocks * block,))[..., :n]


def zero_phase_fir(x: torch.Tensor, taps,
                   padlen: Optional[int] = None,
                   routes: Optional[Routes] = None) -> torch.Tensor:
    """Zero-phase FIR (forward-backward), matching
    ``scipy.signal.filtfilt``: odd extension by ``3·num_taps`` samples and
    steady-state initial conditions seeded from the first extended sample
    (for an FIR that state is a constant input history)."""
    t = int(np.shape(taps)[0])
    n = int(x.shape[-1])
    if padlen is None:
        padlen = 3 * t
    if padlen >= n:
        raise ValueError(f"padlen ({padlen}) must be less than signal "
                         f"length ({n})")

    left = 2.0 * x[..., :1] - torch.flip(x[..., 1:padlen + 1], dims=(-1,))
    right = 2.0 * x[..., -1:] - torch.flip(x[..., -padlen - 1:-1],
                                           dims=(-1,))
    ext = torch.cat([left, x, right], dim=-1)

    # The histories are real copies (``repeat``, not ``expand``): K-FIR
    # reads them with unit stride.
    reps = (1,) * (x.dim() - 1) + (t - 1,)
    fwd = fir_causal(ext, taps, history=ext[..., :1].repeat(reps),
                     routes=routes)
    rev = torch.flip(fwd, dims=(-1,))
    bwd = fir_causal(rev, taps, history=rev[..., :1].repeat(reps),
                     routes=routes)
    # The extension is symmetric, so the kept span is the same indices of
    # the reversed output, flipped back.
    return torch.flip(bwd[..., padlen:padlen + n], dims=(-1,))

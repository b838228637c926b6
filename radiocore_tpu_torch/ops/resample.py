"""FFT-domain arbitrary-ratio resampling (the Fourier method);
counterpart of ``radiocore_tpu/ops/resample.py``.

Semantics follow ``scipy.signal.resample``: the spectrum fold with its
unpaired Nyquist bin, and the one-sided folding of the spectral window
on the real path. Every function builds new tensors: a spectrum handed
in (one band spectrum may serve many channels) is never written to.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.consts import device_array
from radiocore_tpu_torch.runtime.routes import Routes


def _fold_window_onesided(win: np.ndarray, n_rfft: int) -> np.ndarray:
    """Fold a full-length spectral window onto one-sided rfft bins.

    ``W1[l] = (W[l] + W[-l]) / 2`` for ``l > 0`` — scipy's treatment so a
    real signal and its complex cast produce identical results.
    """
    w = np.asarray(win, dtype=np.float64).copy()
    w1 = w[:n_rfft].copy()
    tail = w[-(n_rfft - 1):][::-1]  # W[-l] for l = 1..n_rfft-1
    w1[1:] = (w1[1:] + tail) / 2.0
    return w1


def real_resample_weights(n_x: int, num: int,
                          window: Optional[np.ndarray] = None) -> np.ndarray:
    """What the real path multiplies the kept one-sided bins by: the
    folded window, the unpaired bin's factor and the rate ratio, as one
    float64 array of ``min(num, n_x) // 2 + 1`` weights. Host work, done
    once per plan by callers that resample every chunk."""
    n_x, num = int(n_x), int(num)
    n_rfft = n_x // 2 + 1
    m = min(num, n_x)
    m2 = m // 2 + 1
    w = (np.ones(n_rfft) if window is None
         else _fold_window_onesided(window, n_rfft))[:m2] * (num / n_x)
    if m % 2 == 0 and num != n_x:
        # Unpaired bin at m//2: doubled when downsampling (a bin pair
        # folds into one), halved when upsampling (one bin splits).
        w[m // 2] *= 2.0 if num < n_x else 0.5
    return w


def resample_real(x: torch.Tensor, num: int, weights: torch.Tensor,
                  routes: Optional[Routes] = None) -> torch.Tensor:
    """The real path of :func:`resample_fft` with its weights
    (:func:`real_resample_weights`) already on ``x``'s device."""
    X = _fft.rfft(x, routes)[..., :weights.shape[-1]]
    return _fft.irfft(X * weights, int(num), routes)


def _on(w: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host weights as a real tensor of ``like``'s precision and device,
    copied there once per contents (``ops.consts.device_array``)."""
    return device_array(w, like.device, like.real.dtype)


def resample_fft(x: torch.Tensor, num: int,
                 window: Optional[np.ndarray] = None,
                 routes: Optional[Routes] = None) -> torch.Tensor:
    """Resample ``x`` to ``num`` samples along the last axis.

    Matches ``scipy.signal.resample(x, num, window=window, axis=-1)`` for
    real and complex inputs. ``window``, if given, is a length-``n`` host
    NumPy array applied to the unshifted spectrum. Any leading batch
    dimensions. ``routes`` routes its transforms (``ops/fft``).
    """
    if x.is_complex():
        X = _fft.fft(x, routes)
        if window is not None:
            X = X * _on(np.asarray(window), X)
        return resample_spectrum(X, num, routes)
    # Real path: one-sided FFT with folded window (scipy's rfft branch).
    return resample_real(x, num, _on(
        real_resample_weights(x.shape[-1], num, window), x), routes)


def resample_spectrum(X: torch.Tensor, num: int,
                      routes: Optional[Routes] = None) -> torch.Tensor:
    """Resample from an already computed two-sided spectrum (scipy's
    ``domain='freq'``): one full-band FFT shared by all channels, each
    taking its slice here. ``X`` is left untouched."""
    n_x = int(X.shape[-1])
    num = int(num)
    s_fac = n_x / num
    m = min(num, n_x)
    m2 = m // 2 + 1

    if num == n_x:
        Y = X
    else:
        pos = X[..., :m2]
        neg = X[..., n_x - (m - m2):] if m > m2 else X[..., :0]
        if num < n_x:
            # Downsampling: m2 positive and m − m2 negative bins; the
            # unpaired bin unites the ±m/2 pair.
            if m % 2 == 0:
                last = pos[..., -1:] + X[..., n_x - m // 2:n_x - m // 2 + 1]
                pos = torch.cat([pos[..., :-1], last], dim=-1)
            Y = torch.cat([pos, neg], dim=-1)
        elif m % 2 == 0:
            # Upsampling: zeros in the middle, the unpaired bin split.
            half = 0.5 * pos[..., -1:]
            mid = X.new_zeros(X.shape[:-1] + (num - m - 1,))
            Y = torch.cat([pos[..., :-1], half, mid, half, neg], dim=-1)
        else:
            mid = X.new_zeros(X.shape[:-1] + (num - m,))
            Y = torch.cat([pos, mid, neg], dim=-1)

    return _fft.ifft(Y / s_fac, routes)

"""Spectral-window folding of the FFT resampler; the part of
``radiocore_tpu/ops/resample.py`` the fast WBFM tail uses (scipy
``resample`` semantics on the real path)."""

from __future__ import annotations

import numpy as np


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

"""Host-side filter/window design (NumPy/SciPy, runs at construction time).

All outputs are plain ``numpy`` arrays: they become jit-time constants,
so the accelerator only ever sees static data. This is the TPU analog of
the reference's convention that tap design always uses host scipy
(reference: ``radiocore/_internal/injector.py:22-27``).
"""

from __future__ import annotations

import numpy as np
from scipy import signal as _sig


def window(name: str, n: int) -> np.ndarray:
    """Symmetric-by-default periodic window via scipy ``get_window``.

    Matches the reference's ``_xs.get_window(name, n)`` calls
    (reference: ``radiocore/analog/decimate.py:32``,
    ``radiocore/tools/tuner.py:156``), which return *periodic*
    (``fftbins=True``) windows.
    """
    return _sig.get_window(name, int(n)).astype(np.float64)


def resample_window(name: str, n: int) -> np.ndarray:
    """fftshift'd spectral window used by the FFT resampler.

    Matches ``fftshift(get_window(name, n))``
    (reference: ``radiocore/analog/decimate.py:32-33``,
    ``radiocore/tools/tuner.py:156-157``): peak of the window lands on the
    DC bin of an unshifted spectrum.
    """
    return np.fft.fftshift(window(name, n))


def bandpass_taps(num_taps: int, start_freq: float, stop_freq: float,
                  input_size: int, win: str = "hamm") -> np.ndarray:
    """FIR bandpass taps under the one-second-chunk convention.

    Cutoffs are normalized by ``0.5 * input_size`` because buffer size ==
    sample rate (reference: ``radiocore/analog/bandpass.py:48-57``).
    """
    nyq = 0.5 * float(input_size)
    lo, hi = float(start_freq) / nyq, float(stop_freq) / nyq
    return _sig.firwin(int(num_taps), [lo, hi], pass_zero=False,
                       window=win).astype(np.float64)


def deemphasis_taps(input_size: int, rate: float = 75e-6,
                    num_taps: int = 51) -> np.ndarray:
    """FIR approximation of the single-pole FM de-emphasis filter.

    The reference designs IIR ``b=[1-x], a=[1,-x]`` with
    ``x = exp(-1/(input_size*rate))`` (one-second convention: input_size ≈
    sample rate) and truncates its impulse response to 51 taps
    (reference: ``radiocore/analog/deemphasis.py:36-43``). scipy reads
    ``([1-x], [1,-x])`` as ``(1-x)/(z-x)`` — an inherent one-sample delay —
    so the impulse response is ``h[0] = 0``, ``h[n] = (1-x)·xⁿ⁻¹`` for
    n ≥ 1; the closed form replaces the ``dlti``/``dimpulse`` round-trip.
    """
    x = np.exp(-1.0 / (int(input_size) * float(rate)))
    n = np.arange(int(num_taps))
    h = (1.0 - x) * x ** (n - 1)
    h[0] = 0.0
    return h.astype(np.float64)


def fir_step_history(taps: np.ndarray) -> np.ndarray:
    """Initial input-history for a streaming FIR seeded at unit step state.

    The reference seeds its streaming de-emphasis with
    ``lfilter_zi(taps, 1)`` (reference: ``radiocore/analog/deemphasis.py:48-49``),
    which is the filter state after an infinitely long input of 1.0.
    For an FIR realized as explicit input history, that state is simply a
    history of ones.
    """
    return np.ones(len(taps) - 1, dtype=np.float64)


def hilbert_multiplier(n: int) -> np.ndarray:
    """Frequency-domain multiplier of the analytic-signal (Hilbert) transform.

    ``analytic = ifft(fft(x) * h)`` with h = 1 at DC (and Nyquist when n is
    even), 2 on positive frequencies, 0 on negative frequencies — the same
    spectrum surgery ``scipy.signal.hilbert`` performs
    (reference uses ``_xs.hilbert``: ``radiocore/analog/pll.py:34``).
    """
    n = int(n)
    h = np.zeros(n, dtype=np.float64)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[0] = 1.0
        h[1:(n + 1) // 2] = 2.0
    return h


def filtfilt_padlen(num_taps: int) -> int:
    """Default edge padding of the zero-phase filter (scipy convention 3·ntaps)."""
    return 3 * int(num_taps)

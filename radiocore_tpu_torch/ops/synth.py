"""Device-resident signal synthesis and audio measurement; counterpart of
``radiocore_tpu/ops/synth.py``.

Stereo-multiplex FM IQ generation and tone-SNR measurement run on the
device the caller names, so that IQ enters the device once and only
scalars leave it. The signal convention is that of the host float64
oracles in ``tests/oracles.py``: multiplex = (L+R)/2 +
pilot·sin(2π·19k·t) − sin(2π·38k·t)·(L−R)·w, IQ = exp(jπ·gain·Σ
multiplex).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.runtime.platform import resolve_device

_PHASE_BLOCK = 4096


def _sin_tone(n: int, f: float, fs: float, k0: int = 0, *,
              device: torch.device | str) -> torch.Tensor:
    """``sin(2π·f·k/fs)`` for k = k0..k0+n−1, precise in float32.

    Naive ``sin(2π·f·t)`` in float32 drifts ~1e-2 rad by t = 1 s at FM
    pilot frequencies. Instead the fractional phase ``frac(k·f/fs)`` is
    computed with split arithmetic: k = B·q + r with the per-block
    fractional increment ``frac(B·f/fs)`` precomputed on the host in
    float64, so every float32 product stays small.
    """
    b = _PHASE_BLOCK
    x1 = float(np.mod(np.float64(f) / fs, 1.0))
    xb = float(np.mod(np.float64(f) * b / fs, 1.0))
    k = torch.arange(k0, k0 + n, dtype=torch.int64, device=device)
    q = torch.div(k, b, rounding_mode="floor").to(torch.float32)
    r = torch.remainder(k, b).to(torch.float32)
    frac = torch.remainder(torch.remainder(q * xb, 1.0)
                           + torch.remainder(r * x1, 1.0), 1.0)
    return torch.sin(2 * math.pi * frac)


def stereo_multiplex(n: int, fs: float, f_left: float, f_right: float,
                     pilot_amp: float = 0.1, audio_amp: float = 0.3,
                     compensate_window: bool = True, k0: int = 0, *,
                     device: torch.device | str) -> torch.Tensor:
    """Broadcast-FM stereo multiplex message signal, float32 on
    ``device``. ``k0`` is the starting sample index (chunk streaming
    continuation)."""
    left = audio_amp * _sin_tone(n, f_left, fs, k0, device=device)
    right = audio_amp * _sin_tone(n, f_right, fs, k0, device=device)
    pilot = pilot_amp * _sin_tone(n, 19e3, fs, k0, device=device)
    sub = -_sin_tone(n, 38e3, fs, k0, device=device)
    sub_gain = 1.0
    if compensate_window:
        sub_gain = 1.0 / (0.54 + 0.46 * np.cos(2 * np.pi * 38e3 / fs))
    mpx = (left + right) / 2 + pilot + sub * (left - right) * sub_gain
    return mpx.to(torch.float32)


def fm_modulate(message: torch.Tensor, deviation_gain: float = 0.25,
                phase0: torch.Tensor | float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FM-modulate a real message onto complex baseband, carrying phase.

    Returns ``(iq complex64, end_phase)`` so chunked streams stay
    phase-continuous across calls. The phase is a float32 ``cumsum``,
    whose order of summation differs between devices: hold it to a
    float64 oracle with a limit, not to bit equality.
    """
    phase = phase0 + (math.pi * deviation_gain) * torch.cumsum(
        message.to(torch.float32), dim=-1)
    iq = torch.complex(torch.cos(phase), torch.sin(phase))
    return iq, phase[..., -1]


def stereo_fm_iq(n: int, fs: float, f_left: float, f_right: float,
                 deviation_gain: float = 0.25, *,
                 device: Optional[torch.device | str] = None
                 ) -> torch.Tensor:
    """Stereo FM IQ test signal, complex64 on ``device`` (the card when
    None)."""
    device = resolve_device(device)
    mpx = stereo_multiplex(n, fs, f_left, f_right, device=device)
    iq, _ = fm_modulate(mpx, deviation_gain)
    return iq


def tone_snr_db(x: torch.Tensor, fs: float, f_tone: float,
                guard_bins: int = 3, n_fft: int = 32768,
                skip: int = 2048) -> torch.Tensor:
    """Tone-bin power vs everything else, in dB, computed where ``x``
    lives.

    Device analog of ``tests/oracles.tone_snr_db``: takes an
    ``n_fft``-sample window starting at ``skip`` (clear of filter
    transients), Hann-windowed. Returns a 0-d tensor; only this scalar
    needs to cross to the host.
    """
    seg = x[skip:skip + n_fft].to(torch.float32)
    win = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(x.device)
    spec = torch.abs(torch.fft.rfft(seg * win)) ** 2
    bin_f = int(round(f_tone * n_fft / fs))
    lo = max(bin_f - guard_bins, 0)
    hi = bin_f + guard_bins + 1
    sig_p = torch.sum(spec[lo:hi])
    noise_p = torch.sum(spec) - sig_p
    return 10.0 * torch.log10(sig_p / torch.clamp(noise_p, min=1e-30))

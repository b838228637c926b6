"""WBFM stereo broadcast-FM demodulator, fast modes; counterpart of
``radiocore_tpu/models/wbfm.py`` (``make_wbfm_step`` modes ``fast`` and
``fast_spec``, ``wbfm_init_state`` for the analytic-signal pilot).

The fast pipeline works from the composite (quadrature-demod) rfft
spectrum: the zero-phase pilot bandpass is ``|B(ω)|²`` in frequency, the
L−R channel is ``Im(U·conj(V))`` of the pilot² and 38 kHz envelopes at a
small pow2 rate n2 (the 38 kHz carriers cancel), and the stereo matrix
is decimated by truncating the spectrum. Chunk sizes too small for the
38 kHz slice take the legacy spectrum-reuse path instead. The JAX
module's docstring has the derivation.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.analytic import pll_harmonic
from radiocore_tpu_torch.ops.consts import HostConst
from radiocore_tpu_torch.ops.deemphasis import (deemphasis_apply,
                                                deemphasis_init)
from radiocore_tpu_torch.ops.demod import quadrature_demod
from radiocore_tpu_torch.ops.resample import _fold_window_onesided

State = Dict[str, torch.Tensor]

STEREO_GAIN = 1.0175   # empirical L−R gain (reference: wbfm.py:83)
CLIP = 0.999
PILOT_TAPS = 41        # (reference: wbfm.py:45-46)
PILOT_LO = 19e3 - 50
PILOT_HI = 19e3 + 50


def wbfm_init_state(output_size: int, rate: float = 75e-6,
                    batch_shape: Tuple[int, ...] = (), *,
                    device: torch.device | str) -> State:
    """Initial state (per station when batched): de-emphasis histories
    (the analytic-signal pilot of the fast modes carries no state)."""
    _, hist = deemphasis_init(output_size, rate, batch_shape=batch_shape,
                              device=device)
    return {"deemph_l": hist, "deemph_r": hist.clone()}


def make_wbfm_step(input_size: int, output_size: int,
                   deemphasis: float = 75e-6, mode: str = "fast"
                   ) -> Callable[[torch.Tensor, State],
                                 Tuple[torch.Tensor, State]]:
    """Build the WBFM step for static chunk sizes.

    ``mode='fast'`` maps ``(iq (..., input_size) c64, state) → (audio
    (..., output_size, 2) f32, state)``; ``mode='fast_spec'`` takes the
    composite rfft spectrum ``(..., input_size//2 + 1)`` in place of the
    IQ and carries ``needed_bins``, the highest bin it reads.
    """
    if mode not in ("fast", "fast_spec"):
        raise NotImplementedError(f"mode={mode!r}: only 'fast' and "
                                  f"'fast_spec' are ported")
    n, m = int(input_size), int(output_size)
    win = design.resample_window("hamm", n)
    bp_taps = design.bandpass_taps(PILOT_TAPS, PILOT_LO, PILOT_HI, n)
    de_taps = design.deemphasis_taps(m, deemphasis)

    n_rfft = n // 2 + 1
    w1 = _fold_window_onesided(win, n_rfft)
    b2 = np.abs(np.fft.rfft(bp_taps, n)) ** 2
    h_half = np.full(n_rfft, 2.0)
    h_half[0] = 1.0
    if n % 2 == 0:
        h_half[-1] = 1.0
    pilot_weights = (w1 * b2 * h_half).astype(np.float32)

    m2 = m // 2 + 1
    s_fac = n / m
    # Decimation weights with the unpaired-bin doubling folded in.
    w_dec = w1[:m2].astype(np.float32)
    if m % 2 == 0 and m != n:
        w_dec[m // 2] *= 2.0
    c_w1m2 = HostConst(w1[:m2].astype(np.float32))
    c_wdec = HostConst(w_dec)

    # Envelope-domain slices (see the JAX module for the derivation).
    p0 = int(round(19e3))
    hw = int(2 * n / PILOT_TAPS) + 1500   # pilot mainlobe half-width
    s0, s1 = p0 - hw, p0 + hw             # pilot slice
    hw2 = m2 + 1024                       # audio Nyquist + margin
    s2, e2 = 2 * p0 - hw2, 2 * p0 + hw2   # comp-around-38 kHz slice
    n2 = 1
    while n2 < max(4 * hw, 2 * hw2):
        n2 *= 2
    use_env = (0 < s0 and s1 < n_rfft and 0 < s2 and e2 <= n_rfft
               and n2 <= n)
    if use_env:
        c_pw = HostConst(pilot_weights[s0:s1])
        c_wc = HostConst(w1[s2:e2].astype(np.float32))
        c_phasor = HostConst(np.exp(2j * np.pi * (hw2 - 2 * hw)
                                    * np.arange(n2) / n2).astype(np.complex64))
    else:
        c_w1 = HostConst(w1.astype(np.float32))
        c_pilot = HostConst(pilot_weights)

    def _lmr_env(q_spec: torch.Tensor) -> torch.Tensor:
        """w1-weighted L−R at the envelope rate n2 (real, (..., n2))."""
        dev = q_spec.device
        z = torch.zeros(q_spec.shape[:-1] + (2, n2), dtype=q_spec.dtype,
                        device=dev)
        z[..., 0, :s1 - s0] = q_spec[..., s0:s1] * c_pw.on(dev)
        z[..., 1, :e2 - s2] = q_spec[..., s2:e2] * c_wc.on(dev)
        env = _fft.ifft(z)
        a, v = env[..., 0, :], env[..., 1, :]
        u = a * a
        # A dead channel (zero pilot band) gets a zero subcarrier, not NaN.
        u = u / torch.clamp_min(torch.abs(u), torch.finfo(torch.float32).tiny)
        return torch.imag(u * torch.conj(v) * c_phasor.on(dev)) * STEREO_GAIN

    def step_fast_spec(q_spec: torch.Tensor, state: State
                       ) -> Tuple[torch.Tensor, State]:
        """Fast-mode tail from the composite (quad) rfft spectrum."""
        dev = q_spec.device
        if use_env:
            lmr_trunc = _fft.rfft(_lmr_env(q_spec))[..., :m2]
            comp_trunc = q_spec[..., :m2] * c_w1m2.on(dev)
        else:
            c_spec = q_spec * c_w1.on(dev)
            comp = _fft.irfft(c_spec, n=n)
            z = torch.zeros(c_spec.shape[:-1] + (n,), dtype=c_spec.dtype,
                            device=dev)
            z[..., :n_rfft] = c_spec * c_pilot.on(dev)
            subcarrier = pll_harmonic(_fft.ifft(z), 2, "imag")
            lmr = subcarrier * comp * STEREO_GAIN
            lmr_trunc = _fft.rfft(lmr)[..., :m2]
            comp_trunc = c_spec[..., :m2]
        # One batched irfft for both stereo legs.
        legs = torch.stack([comp_trunc + lmr_trunc,
                            comp_trunc - lmr_trunc], dim=-2)
        lr = _fft.irfft(legs * c_wdec.on(dev) / s_fac, n=m)
        return _finish(lr, state)

    def step_fast(iq: torch.Tensor, state: State
                  ) -> Tuple[torch.Tensor, State]:
        return step_fast_spec(_fft.rfft(quadrature_demod(iq)), state)

    def _finish(lr, state):
        """De-emphasis of both stereo legs, ``lr`` (..., 2, m), in one
        filter call over all rows (on a card one K-FIR launch, which
        measured faster than one per leg: PERF.md); the state keeps a
        history per leg."""
        hist = torch.stack([state["deemph_l"], state["deemph_r"]], dim=-2)
        y, hist = deemphasis_apply(lr, de_taps, hist)
        l, r = y[..., 0, :], y[..., 1, :]
        hist_l, hist_r = hist[..., 0, :], hist[..., 1, :]
        audio = torch.stack([l, r], dim=-1)
        audio = audio - torch.mean(audio, dim=(-2, -1), keepdim=True)
        audio = torch.clamp(audio, -CLIP, CLIP)
        return audio.to(torch.float32), {"deemph_l": hist_l,
                                         "deemph_r": hist_r}

    step_fast_spec.needed_bins = int(max(s1, e2, m2) if use_env else n_rfft)
    return step_fast if mode == "fast" else step_fast_spec

"""WBFM stereo broadcast-FM demodulator; counterpart of
``radiocore_tpu/models/wbfm.py``.

The exact pipeline, stage for stage: quadrature demod at full rate with
the spectral hamming window; the 19 kHz pilot by a 41-tap zero-phase
bandpass; the 38 kHz subcarrier from the pilot's analytic signal squared
(``pll='analytic'``) or from the phase a feedback NCO loop tracks
(``pll='nco'``); the stereo matrix L = comp + (L−R), R = comp − (L−R),
FFT-decimated to the audio rate; streaming de-emphasis per leg; global DC
removal and clip. Every step is batch-generic over leading axes (the
station axis), so one call serves a whole station batch.

The fast pipeline works from the composite (quadrature-demod) rfft
spectrum: the zero-phase pilot bandpass is ``|B(ω)|²`` in frequency, the
L−R channel is ``Im(U·conj(V))`` of the pilot² and 38 kHz envelopes at a
small pow2 rate n2 (the 38 kHz carriers cancel), and the stereo matrix
is decimated by truncating the spectrum. Chunk sizes too small for the
38 kHz slice take the legacy spectrum-reuse path instead. The JAX
module's docstring has the derivation.

``routes`` (:class:`~radiocore_tpu_torch.runtime.routes.Routes`) routes
every transform through ``ops/fft``, the FIRs by ``fir_impl``, and, with
``env_fft="pallas"``, the envelope-rate transforms to K-FFT
(``fft_pow2`` backward for the envelopes, ``rfft_pow2`` for the L−R
channel) where their size is a row, as the reference's
``RADIOCORE_TPU_ENV_FFT`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.analytic import analytic_signal, pll_harmonic
from radiocore_tpu_torch.ops.consts import HostConst
from radiocore_tpu_torch.ops.deemphasis import (deemphasis_apply,
                                                deemphasis_init)
from radiocore_tpu_torch.ops.demod import quadrature_demod
from radiocore_tpu_torch.ops.fir import zero_phase_fir
from radiocore_tpu_torch.ops.nco_pll import (nco_pll_subcarrier, pll_design,
                                             pll_init)
from radiocore_tpu_torch.ops.resample import (_fold_window_onesided,
                                              real_resample_weights,
                                              resample_real)
from radiocore_tpu_torch.runtime.graphs import compile_step
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.profiling import span
from radiocore_tpu_torch.runtime.routes import Routes, resolve
from radiocore_tpu_torch.runtime.transfer import to_device_c64, to_host

# De-emphasis histories, plus ``"pll"`` (a ``PLLState``) with pll='nco'.
State = Dict[str, Any]

STEREO_GAIN = 1.0175   # empirical L−R gain (reference: wbfm.py:83)
CLIP = 0.999
PILOT_TAPS = 41        # (reference: wbfm.py:45-46)
PILOT_LO = 19e3 - 50
PILOT_HI = 19e3 + 50


def wbfm_init_state(output_size: int, rate: float = 75e-6,
                    batch_shape: Tuple[int, ...] = (),
                    pll: str = "analytic", *,
                    device: torch.device | str) -> State:
    """Initial state (per station when batched): de-emphasis histories,
    plus the NCO loop state when ``pll='nco'``."""
    _, hist = deemphasis_init(output_size, rate, batch_shape=batch_shape,
                              device=device)
    state = {"deemph_l": hist, "deemph_r": hist.clone()}
    if pll == "nco":
        state["pll"] = pll_init(batch_shape, device=device)
    return state


def make_wbfm_step(input_size: int, output_size: int,
                   deemphasis: float = 75e-6, mode: str = "exact",
                   pll: str = "analytic", pll_loop_bw: float = 50.0,
                   routes: Optional[Routes] = None
                   ) -> Callable[[torch.Tensor, State],
                                 Tuple[torch.Tensor, State]]:
    """Build the WBFM step for static chunk sizes.

    ``mode='exact'`` (the reference pipeline, stage for stage) and
    ``mode='fast'`` (the same pipeline in the envelope domain, one
    full-length transform per chunk) map ``(iq (..., input_size) c64,
    state) → (audio (..., output_size, 2) f32, state)``;
    ``mode='fast_spec'`` takes the composite rfft spectrum
    ``(..., input_size//2 + 1)`` in place of the IQ and carries
    ``needed_bins``, the highest bin it reads. ``pll='nco'`` (exact mode
    only) tracks the pilot with the feedback loop of ``ops/nco_pll.py``
    and carries its state as ``state["pll"]``, inside a
    ``runtime.profiling`` span ``pll`` (the pilot's RMS and the loop's
    phasor form, which writes the subcarrier). On a dead station (zero
    IQ) the exact mode with the analytic pilot gives NaN audio, the fast
    modes silence. ``routes`` (None: the defaults) routes the transforms
    and FIRs (module docstring).
    """
    if pll not in ("analytic", "nco"):
        raise ValueError(f"unknown pll {pll!r}; 'analytic' or 'nco'")
    if pll == "nco" and mode != "exact":
        raise ValueError("pll='nco' requires mode='exact' (fast mode has "
                         "no explicit pilot time series)")
    if mode not in ("exact", "fast", "fast_spec"):
        raise ValueError(f"unknown mode {mode!r}")
    routes = resolve(routes)
    n, m = int(input_size), int(output_size)
    win = design.resample_window("hamm", n)
    bp_taps = design.bandpass_taps(PILOT_TAPS, PILOT_LO, PILOT_HI, n)
    de_taps = design.deemphasis_taps(m, deemphasis)
    nco_gains = pll_design(n, 19e3, pll_loop_bw)
    # The real-path resample weights of the exact mode: the windowed
    # lowpass at the input rate and the decimation to the audio rate.
    c_lowpass = HostConst(real_resample_weights(n, n, win).astype(np.float32))
    c_decim = HostConst(real_resample_weights(n, m, win).astype(np.float32))

    def step_exact(iq: torch.Tensor, state: State
                   ) -> Tuple[torch.Tensor, State]:
        dev = iq.device
        comp = resample_real(quadrature_demod(iq), n, c_lowpass.on(dev),
                             routes)
        pilot = zero_phase_fir(comp, bp_taps, routes=routes)
        extra = {}
        if pll == "nco":
            # Feedback carrier tracking: the loop bandwidth rejects the
            # pilot-band noise that the analytic path passes straight
            # into the subcarrier's phase.
            with span("pll"):
                subcarrier, extra["pll"] = nco_pll_subcarrier(
                    pilot, nco_gains, state["pll"])
        else:
            subcarrier = pll_harmonic(analytic_signal(pilot, routes), 2,
                                      "imag")
        lmr = subcarrier * comp * STEREO_GAIN
        # Both stereo legs through one batched resample.
        legs = torch.stack([comp + lmr, comp - lmr], dim=-2)
        return _finish(resample_real(legs, m, c_decim.on(dev), routes),
                       state, extra)

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
    env_kernel = routes.env_fft == "pallas" and (n2 & (n2 - 1)) == 0

    def _ifft_env(z: torch.Tensor) -> torch.Tensor:
        if env_kernel and fft_rows.MIN_ROW <= n2 <= fft_rows.MAX_ROW:
            return fft_rows.fft_pow2(z, +1.0) / n2
        return _fft.ifft(z, routes)

    def _rfft_env(x: torch.Tensor) -> torch.Tensor:
        if env_kernel and fft_rows.MIN_ROW <= n2 // 2 <= fft_rows.MAX_ROW:
            return fft_rows.rfft_pow2(x)
        return _fft.rfft(x, routes)

    def _lmr_env(q_spec: torch.Tensor) -> torch.Tensor:
        """w1-weighted L−R at the envelope rate n2 (real, (..., n2))."""
        dev = q_spec.device
        z = torch.zeros(q_spec.shape[:-1] + (2, n2), dtype=q_spec.dtype,
                        device=dev)
        z[..., 0, :s1 - s0] = q_spec[..., s0:s1] * c_pw.on(dev)
        z[..., 1, :e2 - s2] = q_spec[..., s2:e2] * c_wc.on(dev)
        env = _ifft_env(z)
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
            lmr_trunc = _rfft_env(_lmr_env(q_spec))[..., :m2]
            comp_trunc = q_spec[..., :m2] * c_w1m2.on(dev)
        else:
            c_spec = q_spec * c_w1.on(dev)
            comp = _fft.irfft(c_spec, n, routes)
            z = torch.zeros(c_spec.shape[:-1] + (n,), dtype=c_spec.dtype,
                            device=dev)
            z[..., :n_rfft] = c_spec * c_pilot.on(dev)
            subcarrier = pll_harmonic(_fft.ifft(z, routes), 2, "imag")
            lmr = subcarrier * comp * STEREO_GAIN
            lmr_trunc = _fft.rfft(lmr, routes)[..., :m2]
            comp_trunc = c_spec[..., :m2]
        # One batched irfft for both stereo legs.
        legs = torch.stack([comp_trunc + lmr_trunc,
                            comp_trunc - lmr_trunc], dim=-2)
        lr = _fft.irfft(legs * c_wdec.on(dev) / s_fac, m, routes)
        return _finish(lr, state)

    def step_fast(iq: torch.Tensor, state: State
                  ) -> Tuple[torch.Tensor, State]:
        return step_fast_spec(_fft.rfft(quadrature_demod(iq), routes),
                              state)

    def _finish(lr, state, extra=None):
        """De-emphasis of both stereo legs, ``lr`` (..., 2, m), in one
        filter call over all rows (on a card one K-FIR launch, which
        measured faster than one per leg: PERF.md); the state keeps a
        history per leg, and whatever ``extra`` adds."""
        hist = torch.stack([state["deemph_l"], state["deemph_r"]], dim=-2)
        y, hist = deemphasis_apply(lr, de_taps, hist, routes)
        l, r = y[..., 0, :], y[..., 1, :]
        hist_l, hist_r = hist[..., 0, :], hist[..., 1, :]
        audio = torch.stack([l, r], dim=-1)
        audio = audio - torch.mean(audio, dim=(-2, -1), keepdim=True)
        audio = torch.clamp(audio, -CLIP, CLIP)
        new_state = {"deemph_l": hist_l, "deemph_r": hist_r}
        if extra:
            new_state.update(extra)
        return audio.to(torch.float32), new_state

    step_fast_spec.needed_bins = int(max(s1, e2, m2) if use_env else n_rfft)
    return {"exact": step_exact, "fast": step_fast,
            "fast_spec": step_fast_spec}[mode]


class WBFM:
    """Stateful WBFM demodulator with the reference's ``run`` API:
    ``run(input_sig, numpy_output=True)`` gives ``(output_size, 2)``
    stereo audio and carries the state across calls. Runs on ``device``
    (the first CUDA device when None) through ``routes`` (None: the
    defaults). On a card its step is captured once per input signature as
    a CUDA graph and returns fresh tensors (``runtime/graphs``)."""

    def __init__(self, input_size: Union[int, float],
                 output_size: Union[int, float],
                 deemphasis: float = 75e-6, cuda: bool = False,
                 mode: str = "exact", pll: str = "analytic", *,
                 device: Optional[torch.device | str] = None,
                 routes: Optional[Routes] = None):
        del cuda  # kept for the reference's signature; ``device`` decides
        self._input_size = int(input_size)
        self._output_size = int(output_size)
        self._device = resolve_device(device)
        self._step = compile_step(
            make_wbfm_step(self._input_size, self._output_size, deemphasis,
                           mode=mode, pll=pll, routes=routes), self._device)
        self._state = wbfm_init_state(self._output_size, deemphasis, pll=pll,
                                      device=self._device)

    @property
    def channels(self) -> int:
        """Audio channel count (2: stereo)."""
        return 2

    def run(self, input_sig, numpy_output: bool = True):
        """Demodulate one chunk to stereo audio, carrying state across
        calls."""
        if len(input_sig) != self._input_size:
            raise ValueError("input_sig size and input_size mismatch")
        iq = to_device_c64(input_sig, self._device)
        audio, self._state = self._step(iq, self._state)
        return to_host(audio) if numpy_output else audio

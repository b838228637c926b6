"""The plain reference of the multi-station WBFM step (a configuration's
``"reference": "multi_wbfm"``): what the port's
``make_multi_station_step`` computes, written again from the published
math in plain PyTorch and SciPy, in float64. It imports nothing of the
port, of JAX or of the JAX package, and is handed only the band chunks
the harness made.

The chain, for each chunk of the band (one second, ``n`` samples):

1. the band's DFT;
2. each station's bins: the band spectrum rolled by minus the station's
   offset, times a periodic Hann window centred on DC, the first
   ``m/2 + 1`` and the last ``m/2 - 1`` bins kept, the bin at ``-m/2``
   added onto ``+m/2``, an inverse DFT of ``m`` points scaled by ``m/n``;
3. the quadrature demod ``angle(x[t] conj(x[t-1])) / pi``, 0 first;
4. the stereo decoder of the configuration's mode:

   * ``exact``, the reference receiver's chain: the demod resampled to
     its own rate through a Hamming spectral window; the 19 kHz pilot by
     a 41-tap Hamming bandpass run forward and backward (``filtfilt``:
     odd extension of 123 samples, steady-state start); the 38 kHz
     subcarrier ``Im(a^2) / |a^2|`` of the pilot's analytic signal;
     L-R = subcarrier x composite x 1.0175; both legs resampled to the
     audio rate through the same window;
   * ``fast``, the same in the envelope domain (the JAX package's
     ``models/wbfm.py`` derives it): the pilot band weighted by the
     bandpass's squared magnitude and the composite around 38 kHz
     brought down to a small power-of-two rate, L-R as
     ``Im(u conj(v))`` of the pilot envelope squared (unit modulus) and
     the 38 kHz envelope, the stereo matrix decimated by truncating the
     spectra;

5. de-emphasis of each leg by the 51-tap FIR of the 75 us pole, its 50
   last inputs carried to the next chunk (ones at the start); the mean
   of both legs removed; a clip at 0.999.

``precision="bfloat16"`` is the control: the same chain in float32 with
every stage's output rounded to bfloat16, the nearest precision below
the float32 that the configuration states (``"precision"``). It must
fail the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sig

from portbench import signals

STEREO_GAIN = 1.0175
CLIP = 0.999
PILOT_TAPS = 41
PILOT_BAND = (19e3 - 50, 19e3 + 50)
DEEMPH_TAPS = 51
BLOCK = 16          # stations a pass: bounds the reference's memory


def deemphasis_taps(rate_hz: int, tau: float) -> np.ndarray:
    """The single pole ``(1-x) / (z-x)``, ``x = exp(-1/(rate tau))``, cut
    to 51 taps: ``h[0] = 0``, ``h[k] = (1-x) x^(k-1)``."""
    x = math.exp(-1.0 / (int(rate_hz) * float(tau)))
    k = np.arange(DEEMPH_TAPS, dtype=np.float64)
    h = (1.0 - x) * x ** (k - 1)
    h[0] = 0.0
    return h


def spectral_window(name: str, n: int) -> np.ndarray:
    """A periodic window of ``n`` points rotated so that its peak sits on
    the DC bin of an unshifted spectrum."""
    return np.fft.fftshift(sig.get_window(name, n))


class Reference:
    """The reference chain for one configuration, on ``device``."""

    def __init__(self, config: dict, precision: str = "float64", *,
                 device: torch.device | str = "cpu"):
        if precision not in ("float64", "bfloat16"):
            raise ValueError(f"precision {precision!r}")
        if config["precision"] != "float32":
            raise ValueError(f"the port serves float32; the configuration "
                             f"states {config['precision']!r}")
        self.mode = config["mode"]
        if self.mode not in ("fast", "exact"):
            raise ValueError(f"mode {self.mode!r}")
        self.low = precision == "bfloat16"
        self.device = torch.device(device)
        self.real = torch.float32 if self.low else torch.float64
        self.cplx = torch.complex64 if self.low else torch.complex128
        self.c = int(config["stations"])
        self.sc = n = int(config["station_rate"])
        self.n_band = int(config["band_rate"])
        self.m = m = int(config["audio_rate"])
        self.offsets = signals.offsets(config)
        nb, sc = self.n_band, n
        # Extraction: kept bins in output order, their window, the fix bin.
        m2 = sc // 2 + 1
        self.keep = np.concatenate([np.arange(m2),
                                    np.arange(nb - (sc - m2), nb)])
        self.fix = nb - sc // 2
        hann = spectral_window("hann", nb)
        self.w_keep = self._t(hann[self.keep])
        self.w_fix = float(hann[self.fix])
        # Demod tail constants.
        hamm = spectral_window("hamming", n)
        nr = n // 2 + 1
        w1 = hamm[:nr].copy()
        w1[1:] = (w1[1:] + hamm[::-1][:nr - 1]) / 2.0
        self.w1 = w1
        nyq = 0.5 * n
        self.bp = sig.firwin(PILOT_TAPS, [f / nyq for f in PILOT_BAND],
                             pass_zero=False, window="hamming")
        self.de = deemphasis_taps(m, float(config["deemphasis_s"]))
        mh = m // 2 + 1
        w_dec = w1[:mh] * (m / n)
        if m % 2 == 0 and m != n:
            w_dec[m // 2] *= 2.0
        self.w_dec = self._t(w_dec)
        self.w1_t = self._t(w1)
        if self.mode == "fast":
            self._fast_consts(n, m)
        else:
            h = np.zeros(n)
            h[0] = h[n // 2] = 1.0
            h[1:n // 2] = 2.0
            self.hilbert = self._t(h)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            self.cplx if np.iscomplexobj(a) else self.real)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A stage's output as the control stores it: bfloat16."""
        if not self.low:
            return x
        if x.is_complex():
            return torch.complex(x.real.to(torch.bfloat16).float(),
                                 x.imag.to(torch.bfloat16).float())
        return x.to(torch.bfloat16).float()

    def _fast_consts(self, n: int, m: int) -> None:
        nr = n // 2 + 1
        b2 = np.abs(np.fft.rfft(self.bp, n)) ** 2
        h_half = np.full(nr, 2.0)
        h_half[0] = h_half[-1] = 1.0
        pw = self.w1 * b2 * h_half
        mh = m // 2 + 1
        p0 = 19000
        hw = int(2 * n / PILOT_TAPS) + 1500
        self.s0, self.s1 = p0 - hw, p0 + hw
        hw2 = mh + 1024
        self.s2, self.e2 = 2 * p0 - hw2, 2 * p0 + hw2
        n2 = 1
        while n2 < max(4 * hw, 2 * hw2):
            n2 *= 2
        if not (0 < self.s0 and self.s1 < nr and 0 < self.s2
                and self.e2 <= nr and n2 <= n):
            raise ValueError(f"station rate {n} and audio rate {m} give no "
                             f"envelope-domain plan")
        self.n2 = n2
        self.pw = self._t(pw[self.s0:self.s1])
        self.wc = self._t(self.w1[self.s2:self.e2])
        self.phasor = self._t(np.exp(2j * np.pi * (hw2 - 2 * hw)
                                     * np.arange(n2) / n2))

    # -- the chain -----------------------------------------------------

    def spectrum(self, band: torch.Tensor) -> torch.Tensor:
        """Step 1: the band chunk's DFT."""
        band = self.q(band.to(device=self.device, dtype=self.cplx))
        return self.q(torch.fft.fft(band))

    def stations(self, spec: torch.Tensor, rows: slice) -> torch.Tensor:
        """Step 2 for the stations in ``rows``: ``(rows, sc)`` IQ."""
        nb, sc = self.n_band, self.sc
        offs = torch.tensor(self.offsets[rows], device=self.device)[:, None]
        keep = torch.as_tensor(self.keep, device=self.device)
        y = spec[(keep + offs) % nb] * self.w_keep
        y[:, sc // 2] += spec[(self.fix + offs[:, 0]) % nb] * self.w_fix
        return self.q(torch.fft.ifft(y * (sc / nb), dim=-1))

    def demod(self, iq: torch.Tensor) -> torch.Tensor:
        """Step 3."""
        d = iq[:, 1:] * torch.conj(iq[:, :-1])
        return self.q(F.pad(torch.angle(d) / math.pi, (1, 0)))

    def legs(self, band: torch.Tensor) -> torch.Tensor:
        """Steps 1 to 4 of one chunk: ``(c, 2, m)``, both legs before the
        de-emphasis."""
        spec = self.spectrum(band)
        out = []
        for b in range(0, self.c, BLOCK):
            quad = self.demod(self.stations(spec, slice(b, b + BLOCK)))
            out.append(self._fast(quad) if self.mode == "fast"
                       else self._exact(quad))
        return torch.cat(out)

    def _decimate(self, legs_spec: torch.Tensor) -> torch.Tensor:
        mh = self.m // 2 + 1
        return self.q(torch.fft.irfft(legs_spec[..., :mh] * self.w_dec,
                                      self.m))

    def _fast(self, quad: torch.Tensor) -> torch.Tensor:
        qs = self.q(torch.fft.rfft(quad))
        n2 = self.n2
        z = torch.zeros(qs.shape[:-1] + (2, n2), dtype=qs.dtype,
                        device=qs.device)
        z[:, 0, :self.s1 - self.s0] = qs[:, self.s0:self.s1] * self.pw
        z[:, 1, :self.e2 - self.s2] = qs[:, self.s2:self.e2] * self.wc
        env = self.q(torch.fft.ifft(z))
        a, v = env[:, 0], env[:, 1]
        u = a * a
        u = u / torch.clamp_min(torch.abs(u), torch.finfo(self.real).tiny)
        lmr = self.q(torch.imag(u * torch.conj(v) * self.phasor)
                     * STEREO_GAIN)
        mh = self.m // 2 + 1
        lmr_s = self.q(torch.fft.rfft(lmr))[:, :mh]
        comp_s = qs[:, :mh] * self.w1_t[:mh]
        return self._decimate(torch.stack([comp_s + lmr_s, comp_s - lmr_s],
                                          dim=1))

    def _exact(self, quad: torch.Tensor) -> torch.Tensor:
        n = self.sc
        comp = self.q(torch.fft.irfft(torch.fft.rfft(quad) * self.w1_t, n))
        pilot = self.q(self._filtfilt(comp))
        a = self.q(torch.fft.ifft(torch.fft.fft(pilot) * self.hilbert))
        a2 = a * a
        sub = torch.imag(a2) / torch.abs(a2)
        lmr = self.q(sub * comp * STEREO_GAIN)
        legs = torch.stack([comp + lmr, comp - lmr], dim=1)
        return self._decimate(self.q(torch.fft.rfft(legs)))

    def _fir(self, x: torch.Tensor, taps: np.ndarray,
             hist: torch.Tensor) -> torch.Tensor:
        """Causal FIR ``y[t] = sum_k b[k] x[t-k]`` over the last axis, the
        ``len(taps)-1`` samples before ``x`` given as ``hist``."""
        t = len(taps)
        xp = torch.cat([hist, x], dim=-1)
        w = self._t(taps[::-1].copy()).view(1, 1, t)
        y = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]), w)
        return y.reshape(x.shape)

    def _filtfilt(self, x: torch.Tensor) -> torch.Tensor:
        """``scipy.signal.filtfilt(bp, 1, x)`` with its defaults (odd
        extension of 3 x taps, each pass started in the steady state of
        its first sample)."""
        t, n = PILOT_TAPS, x.shape[-1]
        pad = 3 * t
        left = 2.0 * x[:, :1] - torch.flip(x[:, 1:pad + 1], dims=(-1,))
        right = 2.0 * x[:, -1:] - torch.flip(x[:, -pad - 1:-1], dims=(-1,))
        ext = torch.cat([left, x, right], dim=-1)
        fwd = self._fir(ext, self.bp, ext[:, :1].expand(-1, t - 1))
        rev = torch.flip(fwd, dims=(-1,))
        bwd = self._fir(rev, self.bp, rev[:, :1].expand(-1, t - 1))
        return torch.flip(bwd, dims=(-1,))[:, pad:pad + n]

    def finish(self, legs: torch.Tensor, hist: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step 5: ``(audio (c, m, 2), history (c, 2, 50))`` of one chunk
        from its legs and the previous chunk's history."""
        y = self.q(self._fir(legs, self.de, hist.to(legs.dtype)))
        audio = y.transpose(1, 2)
        audio = audio - audio.mean(dim=(1, 2), keepdim=True)
        audio = torch.clamp(audio, -CLIP, CLIP)
        return self.q(audio), legs[..., -(DEEMPH_TAPS - 1):]

    def initial_history(self) -> torch.Tensor:
        return torch.ones(self.c, 2, DEEMPH_TAPS - 1, dtype=self.real,
                          device=self.device)


def pool_answers(ref: Reference, pool: torch.Tensor
                 ) -> List[Dict[str, torch.Tensor]]:
    """For each chunk ``p`` of a pool that cycles, what a step on it gives
    after a step on chunk ``p - 1``: ``{"audio": (c, m, 2), "deemph_l":
    (c, 50), "deemph_r": (c, 50)}`` on the reference's device."""
    legs = [ref.legs(pool[p]) for p in range(pool.shape[0])]
    out = []
    for p in range(len(legs)):
        hist = legs[p - 1][..., -(DEEMPH_TAPS - 1):]
        audio, new = ref.finish(legs[p], hist)
        out.append({"audio": audio, "deemph_l": new[:, 0],
                    "deemph_r": new[:, 1]})
    return out


def first_answer(ref: Reference, band: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """What a step from the initial state gives on ``band``."""
    audio, new = ref.finish(ref.legs(band), ref.initial_history())
    return {"audio": audio, "deemph_l": new[:, 0], "deemph_r": new[:, 1]}


def answers(config: dict, pool: torch.Tensor, device: torch.device
            ) -> List[Dict[str, torch.Tensor]]:
    """The harness's entry: the float64 answers for each position of a
    pool that cycles (:func:`pool_answers`)."""
    return pool_answers(Reference(config, "float64", device=device), pool)


def control_step(config: dict, device: torch.device):
    """The control in the program's place: ``(step, state)`` shaped as
    the port's ``make_multi_station_step`` gives them, computing each
    chunk by the bfloat16 reference from its own initial state."""
    ref = Reference(config, "bfloat16", device=device)

    def step(band: torch.Tensor, state: Dict[str, torch.Tensor]):
        hist = torch.stack([state["deemph_l"], state["deemph_r"]], dim=1)
        audio, new = ref.finish(ref.legs(band), hist)
        return audio.float(), {"deemph_l": new[:, 0].float().contiguous(),
                               "deemph_r": new[:, 1].float().contiguous()}

    h = ref.initial_history()
    return step, {"deemph_l": h[:, 0].clone(), "deemph_r": h[:, 1].clone()}

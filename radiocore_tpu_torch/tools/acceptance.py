"""The port's acceptance drive: BASELINE.md's acceptance configs 1-4 and
its fidelity bar; counterpart of ``benchmarks/tpu_acceptance.py`` and
``benchmarks/fidelity.py``.

Run from the root of a checkout::

    python3 -m radiocore_tpu_torch.tools.acceptance [--configs 1,2,3,4]
        [--fidelity 1,2,3] [--device cpu]

The device is the card unless ``--device`` names another; without a
card and without ``--device`` it raises and never falls back to the CPU.

- **Acceptance configs** (IQ made on the device by ``ops/synth``, tone
  SNRs measured there): 1, 2.4 MS/s stereo FM resampled to 250 kS/s and
  demodulated by the MFM step to 48 kHz (tone > 20 dB); 2, the WBFM step
  at 250 kS/s in ``exact`` and ``fast`` (left and right > 20 dB,
  separation > 10 dB); 3, the ``fast`` multi-station step on 8 stations
  of 262 144 S/s stacked into a 2^21 band (worst tone > 15 dB); 4, K-FIR
  at 257 taps on 4 x 262 144 float32 noise against ``fir_overlap_save``
  (rel max error < 1e-5), each also against a float64 ``np.convolve``.
- **Fidelity configs** (the same seeded NumPy inputs through the float64
  oracle chain of ``tests/oracles.py`` on the host and through the port's
  classes on the device): 1, ``Decimate`` 2.4 MS/s -> 240 kS/s then
  ``MFM``; 2, ``Decimate`` then ``WBFM``; 3, the ``Tuner`` on a 10 MS/s
  band of 8 stations, then ``WBFM`` per channel. Bars: the match SNR
  above 40 dB (the bound the port's CPU tests hold) and every tone's SNR
  within 1 dB of the oracle's (BASELINE.md: "within 1 dB SNR").

On a CUDA device each check also carries the launches of the kernels its
path must go through (K-FIR everywhere; K-EXTRACT, K-FFT ``rfft_pow2``
and K-FIR in config 3), counted from 0 around the path, and fails if one
of them launched no time.

Prints one JSON line per check, ``{"check", "value", "ok", ...}``, then
``{"acceptance": "PASS"|"FAIL"}``; :func:`main` returns 0 or 1. The
fidelity configs import ``tests/oracles.py`` from the checkout.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
SEED = 2
AUDIO = 48_000

SNR_MIN_DB = 20.0          # configs 1 and 2, per tone
SEPARATION_MIN_DB = 10.0   # config 2
MULTI_MIN_DB = 15.0        # config 3, worst tone
FIR_REL_MAX = 1e-5         # config 4
MATCH_MIN_DB = 40.0        # fidelity, tests/test_torch_models.py
TONE_DIFF_MAX_DB = 1.0     # fidelity, BASELINE.md
BASELINE_BAR = ("audio within 1 dB SNR of the CPU (NumPy/SciPy) reference "
                "path (BASELINE.md)")
# The JAX package's match SNRs from benchmarks/fidelity.py on the CPU,
# printed beside the port's for comparison.
JAX_CPU_MATCH_DB = {1: 137.7, 2: 131.7, 3: 132.6}

# Config 3: 8 stations of 262 144 S/s in a 2^21 band.
MULTI_STATIONS, MULTI_CHUNK, MULTI_AUDIO = 8, 262_144, 49_152
FIR_TAPS, FIR_ROWS, FIR_N = 257, 4, 262_144


def check(name: str, value: float, ok: bool,
          extra: Optional[dict] = None) -> bool:
    """Print one check's JSON line; return ``ok``."""
    rec = {"check": name, "value": float(f"{float(value):.4g}"),
           "ok": bool(ok)}
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)
    return bool(ok)


def _counters(names: Sequence[str]) -> Dict[str, object]:
    from radiocore_tpu_torch.kernels import extract, fft_rows, fir
    table = {"K-FIR": fir.launches, "K-EXTRACT": extract.launches,
             "K-FFT rfft_pow2": fft_rows.entry_launches["rfft_pow2"]}
    return {name: table[name] for name in names}


def launched(device: torch.device, names: Sequence[str], fn: Callable):
    """``fn()``'s result and, on a CUDA device, the launches of the
    kernels ``names`` during it (each counter set to 0 just before);
    None on the CPU, where the kernels' plain versions run."""
    if device.type != "cuda":
        return fn(), None
    counters = _counters(names)
    torch.cuda.synchronize(device)
    for counter in counters.values():
        counter.reset()
    out = fn()
    torch.cuda.synchronize(device)
    return out, {name: c.count for name, c in counters.items()}


def _launch_extra(launches) -> Tuple[dict, bool]:
    """The check line's ``launches`` field, and whether each launched."""
    if launches is None:
        return {}, True
    return {"launches": launches}, all(v > 0 for v in launches.values())


# ---------------------------------------------------------------------------
# Acceptance configs 1-4 (benchmarks/tpu_acceptance.py)
# ---------------------------------------------------------------------------

def config1(device: torch.device) -> bool:
    """Mono FM: 2.4 MS/s -> 250 kS/s (``resample_fft``) -> MFM -> 48 kHz."""
    from radiocore_tpu_torch.models.mfm import make_mfm_step, mfm_init_state
    from radiocore_tpu_torch.ops import synth
    from radiocore_tpu_torch.ops.resample import resample_fft
    fs_in, fs = 2_400_000, 250_000

    def run():
        iq = synth.stereo_fm_iq(fs_in, float(fs_in), 440.0, 440.0,
                                device=device)
        iq = resample_fft(iq, fs)
        audio, _ = make_mfm_step(fs, AUDIO)(
            iq, mfm_init_state(AUDIO, device=device))
        return float(synth.tone_snr_db(audio, AUDIO, 440.0))

    snr, launches = launched(device, ["K-FIR"], run)
    extra, all_ran = _launch_extra(launches)
    return check("config1_mfm_mono_snr_db", snr,
                 snr > SNR_MIN_DB and all_ran, extra)


def wbfm_audio(iq: torch.Tensor, mode: str) -> torch.Tensor:
    """Config 2's path: one chunk of 250 kS/s IQ through the WBFM step from
    its initial state -> (48 000, 2) audio on ``iq``'s device."""
    from radiocore_tpu_torch.models.wbfm import make_wbfm_step, wbfm_init_state
    step = make_wbfm_step(250_000, AUDIO, mode=mode)
    audio, _ = step(iq, wbfm_init_state(AUDIO, device=iq.device))
    return audio


def config2(device: torch.device) -> bool:
    """WBFM stereo at 250 kS/s, pilot tracking and de-emphasis, in both
    modes."""
    from radiocore_tpu_torch.ops import synth
    fs = 250_000
    ok = True
    for mode in ("exact", "fast"):
        def run():
            iq = synth.stereo_fm_iq(fs, float(fs), 440.0, 1000.0,
                                    device=device)
            audio = wbfm_audio(iq, mode)
            return tuple(float(v) for v in (
                synth.tone_snr_db(audio[:, 0], AUDIO, 440.0),
                synth.tone_snr_db(audio[:, 1], AUDIO, 1000.0),
                synth.tone_snr_db(audio[:, 1], AUDIO, 440.0)))

        (left, right, leak), launches = launched(device, ["K-FIR"], run)
        extra, all_ran = _launch_extra(launches)
        ok &= check(f"config2_wbfm_{mode}_left_snr_db", left,
                    left > SNR_MIN_DB and all_ran, extra)
        ok &= check(f"config2_wbfm_{mode}_right_snr_db", right,
                    right > SNR_MIN_DB)
        ok &= check(f"config2_wbfm_{mode}_separation_db", right - leak,
                    right - leak > SEPARATION_MIN_DB)
    return ok


def multi_station_band(device: torch.device) -> Tuple[torch.Tensor,
                                                      list, list]:
    """Config 3's band: each station made at its own rate and its
    spectrum stacked at its offset in the band (the layout the extractor
    inverts). Returns the band, the offsets and the (left, right) tones."""
    from radiocore_tpu_torch.ops import synth
    c, sc = MULTI_STATIONS, MULTI_CHUNK
    n_band = c * sc
    half = n_band // 2 - sc // 2
    offsets = [int(-half + i * sc) for i in range(c)]
    tones = [(300.0 + 50 * i, 700.0 + 80 * i) for i in range(c)]
    band_spec = torch.zeros(n_band, dtype=torch.complex64, device=device)
    h = sc // 2
    for off, (fl, fr) in zip(offsets, tones):
        iq = synth.stereo_fm_iq(sc, float(sc), fl, fr, device=device)
        start = (off % n_band - h) % n_band
        band_spec[start:start + sc] = torch.fft.fftshift(torch.fft.fft(iq))
    return torch.fft.ifft(band_spec), offsets, tones


def config3(device: torch.device) -> bool:
    """The ``fast`` multi-station step, 8 x 262 144 -> 49 152 in a 2^21
    band: K-EXTRACT, K-FFT's ``rfft_pow2`` and K-FIR on the card (the
    band's transform is below ``fft_kernel_min``: the library's)."""
    from radiocore_tpu_torch.ops import synth
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    c, sc, ac = MULTI_STATIONS, MULTI_CHUNK, MULTI_AUDIO
    band, offsets, tones = multi_station_band(device)
    step, state = make_multi_station_step(c * sc, offsets, sc, ac,
                                          mode="fast", device=device)
    audio, launches = launched(
        device, ["K-EXTRACT", "K-FFT rfft_pow2", "K-FIR"],
        lambda: step(band, state)[0])
    snrs = []
    for i, (fl, fr) in enumerate(tones):
        snrs.append(float(synth.tone_snr_db(audio[i, :, 0], ac, fl)))
        snrs.append(float(synth.tone_snr_db(audio[i, :, 1], ac, fr)))
    worst = min(snrs)
    extra, all_ran = _launch_extra(launches)
    return check("config3_8station_worst_tone_snr_db", worst,
                 worst > MULTI_MIN_DB and all_ran,
                 {"stations": c, **extra})


def config4(device: torch.device) -> bool:
    """K-FIR at 257 taps against the FFT overlap-save form (two float32
    arms of different arithmetic), and each against float64."""
    from scipy import signal as sig
    from radiocore_tpu_torch.kernels.fir import fir_causal_rows
    from radiocore_tpu_torch.ops.fir import fir_overlap_save
    taps = sig.firwin(FIR_TAPS, 0.25).astype(np.float32)
    x = np.random.default_rng(SEED).standard_normal(
        (FIR_ROWS, FIR_N)).astype(np.float32)
    xd = torch.from_numpy(x).to(device)
    a, launches = launched(device, ["K-FIR"],
                           lambda: fir_causal_rows(xd, taps).cpu().numpy())
    c = fir_overlap_save(xd, taps).cpu().numpy()
    want = np.stack([np.convolve(row.astype(np.float64),
                                 taps.astype(np.float64))[:FIR_N]
                     for row in x])
    scale = np.max(np.abs(want))
    rel = float(np.max(np.abs(a - c)) / np.max(np.abs(c)))
    rel_a = float(np.max(np.abs(a - want)) / scale)
    rel_c = float(np.max(np.abs(c - want)) / scale)
    extra, all_ran = _launch_extra(launches)
    return check("config4_fir_rel_err", rel,
                 max(rel, rel_a, rel_c) < FIR_REL_MAX and all_ran,
                 {"taps": FIR_TAPS, "shape": [FIR_ROWS, FIR_N],
                  "kfir_vs_float64": float(f"{rel_a:.4g}"),
                  "overlap_save_vs_float64": float(f"{rel_c:.4g}"),
                  "note": "K-FIR vs FFT overlap-save, both float32"
                  + ("" if device.type == "cuda"
                     else "; on the CPU the K-FIR arm is its plain version"),
                  **extra})


# ---------------------------------------------------------------------------
# Fidelity configs 1-3 (benchmarks/fidelity.py)
# ---------------------------------------------------------------------------

def _oracles():
    tests = str(REPO / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import oracles
    return oracles


def _station_band(oracles, fs_in: int, fs_demod: int) -> np.ndarray:
    """One stereo station (440 Hz left, 1 kHz right) at ``fs_demod``,
    upsampled to the SDR rate ``fs_in`` (periodic, exact in spectrum)."""
    mpx = oracles.make_stereo_multiplex(fs_demod, fs_demod, 440.0, 1000.0)
    spec = np.fft.fft(oracles.make_fm_iq(mpx, 0.25))
    up = np.zeros(fs_in, np.complex128)
    up[:fs_demod // 2] = spec[:fs_demod // 2]
    up[-fs_demod // 2:] = spec[-fs_demod // 2:]
    return np.fft.ifft(up) * (fs_in / fs_demod)


def _tone_diff(oracles, want: np.ndarray, got: np.ndarray, fs: int,
               tones: Sequence[Tuple[int, float]]) -> float:
    """The largest |tone SNR(port) - tone SNR(oracle)| over ``tones``,
    (channel, Hz) pairs of the (n, channels) audio, edges left out."""
    worst = 0.0
    for ch, f in tones:
        a = oracles.tone_snr_db(got[2000:-2000, ch], fs, f)
        b = oracles.tone_snr_db(want[2000:-2000, ch], fs, f)
        worst = max(worst, abs(a - b))
    return worst


def _fidelity_checks(k: int, name: str, match: float, diff: float,
                     launches) -> bool:
    extra, all_ran = _launch_extra(launches)
    ok = check(f"fidelity{k}_{name}_match_snr_db", match,
               match > MATCH_MIN_DB and all_ran,
               {"bar_db": MATCH_MIN_DB, "baseline": BASELINE_BAR,
                "jax_cpu_match_snr_db": JAX_CPU_MATCH_DB[k],
                "jax_cpu_source": "benchmarks/fidelity.py, JAX package on "
                                  "the CPU", **extra})
    return ok & check(f"fidelity{k}_{name}_tone_snr_diff_db", diff,
                      diff <= TONE_DIFF_MAX_DB,
                      {"bar_db": TONE_DIFF_MAX_DB})


def fidelity1(device: torch.device) -> bool:
    """Mono: 2.4 MS/s -> ``Decimate`` to 240 kS/s -> ``MFM`` -> 48 kHz."""
    from radiocore_tpu_torch.models import MFM, Decimate
    oracles = _oracles()
    fs_in, fs_demod = 2_400_000, 240_000
    band = _station_band(oracles, fs_in, fs_demod)
    want, _ = oracles.mfm(oracles.decimate(band, fs_demod), fs_demod, AUDIO)

    def run():
        station = Decimate(fs_in, fs_demod, device=device).run(
            band.astype(np.complex64))
        return MFM(fs_demod, AUDIO, device=device).run(station)[:, 0]

    got, launches = launched(device, ["K-FIR"], run)
    diff = _tone_diff(oracles, want[:, None], got[:, None], AUDIO,
                      [(0, 440.0), (0, 1000.0)])
    return _fidelity_checks(1, "mfm", oracles.snr_db(want, got), diff,
                            launches)


def fidelity2(device: torch.device) -> bool:
    """Stereo: 2.4 MS/s -> ``Decimate`` to 240 kS/s -> ``WBFM``."""
    from radiocore_tpu_torch.models import WBFM, Decimate
    oracles = _oracles()
    fs_in, fs_demod = 2_400_000, 240_000
    band = _station_band(oracles, fs_in, fs_demod)
    want, _ = oracles.wbfm(oracles.decimate(band, fs_demod), fs_demod, AUDIO)

    def run():
        station = Decimate(fs_in, fs_demod, device=device).run(
            band.astype(np.complex64))
        return WBFM(fs_demod, AUDIO, device=device).run(station)

    got, launches = launched(device, ["K-FIR"], run)
    match = min(oracles.snr_db(want[:, ch], got[:, ch]) for ch in (0, 1))
    diff = _tone_diff(oracles, want, got, AUDIO, [(0, 440.0), (1, 1000.0)])
    return _fidelity_checks(2, "wbfm", match, diff, launches)


def fidelity3(device: torch.device) -> bool:
    """The ``Tuner`` channelizes a 10 MS/s band into 8 stations of 240 kS/s,
    then ``WBFM`` per channel, against the roll, Hann and
    frequency-domain resample oracle."""
    from scipy import signal as sig
    from radiocore_tpu_torch.models import WBFM
    from radiocore_tpu_torch.tools.tuner import Tuner
    oracles = _oracles()
    fs_band, bw, n_st = 10_000_000, 240_000, 8
    center = 100_000_000
    offsets = [(i - (n_st - 1) / 2) * 1_000_000 for i in range(n_st)]
    tones = [(300.0 + 40 * i, 900.0 + 60 * i) for i in range(n_st)]

    tuner = Tuner(device=device)
    for off in offsets:
        tuner.add_channel(center + off, bw, WBFM(bw, AUDIO, device=device))
    tuner.request_bandwidth(fs_band)
    n = int(tuner.input_bandwidth)
    band = np.zeros(n, np.complex128)
    for off, (fl, fr) in zip(offsets, tones):
        mpx = oracles.make_stereo_multiplex(bw, bw, fl, fr)
        spec = np.fft.fft(oracles.make_fm_iq(mpx, 0.25))
        up = np.zeros(n, np.complex128)
        up[:bw // 2] = spec[:bw // 2]
        up[-bw // 2:] = spec[-bw // 2:]
        band += (np.fft.ifft(up) * (n / bw)
                 * np.exp(2j * np.pi * int(off) * np.arange(n) / n))
    band = band.astype(np.complex64)

    def run():
        tuner.load(band)
        stations = tuner.run_all()
        return [ch.demodulator.run(stations[i])
                for i, ch in enumerate(tuner.channels())]

    gots, launches = launched(device, ["K-FIR"], run)
    win = np.fft.fftshift(sig.get_window("hann", n))
    spectrum = np.fft.fft(band.astype(np.complex128))
    match, diff = np.inf, 0.0
    for ch, got, (fl, fr) in zip(tuner.channels(), gots, tones):
        shift = int(tuner.input_frequency - ch.center_frequency)
        st_ref = sig.resample(np.roll(spectrum, shift) * win, bw,
                              domain="freq")
        want, _ = oracles.wbfm(st_ref, bw, AUDIO)
        match = min(match, *(oracles.snr_db(want[:, c], got[:, c])
                             for c in (0, 1)))
        diff = max(diff, _tone_diff(oracles, want, got, AUDIO,
                                    [(0, fl), (1, fr)]))
    return _fidelity_checks(3, "tuner_8ch_worst", match, diff, launches)


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4}
FIDELITY = {1: fidelity1, 2: fidelity2, 3: fidelity3}


def _numbers(text: str, known) -> list:
    picked = sorted({int(c) for c in text.split(",") if c.strip()})
    unknown = [c for c in picked if c not in known]
    if unknown:
        raise SystemExit(f"unknown config(s) {unknown}; "
                         f"one of {sorted(known)}")
    return picked


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the selected checks; 0 when every one passed, else 1."""
    from radiocore_tpu_torch.runtime.platform import resolve_device
    parser = argparse.ArgumentParser(
        description="The port's acceptance drive (BASELINE.md configs "
                    "1-4 and its fidelity bar, configs 1-3).")
    parser.add_argument("--configs", default="1,2,3,4",
                        help="acceptance configs, comma-separated")
    parser.add_argument("--fidelity", default="1,2,3",
                        help="fidelity configs, comma-separated")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    configs = _numbers(args.configs, CONFIGS)
    fidelity = _numbers(args.fidelity, FIDELITY)
    device = resolve_device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(json.dumps({"device": str(device), "kind": kind}), flush=True)
    ok = True
    for k in configs:
        ok &= CONFIGS[k](device)
    for k in fidelity:
        ok &= FIDELITY[k](device)
    print(json.dumps({"acceptance": "PASS" if ok else "FAIL"}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""The port's Tuner (``tools/tuner.py``) against ``tests/test_tuner.py``:
the band plan to the digit, tone extraction, the scipy reference path,
and ``run(i)`` / ``run_all`` against the JAX Tuner on the same seeded
band, on the CPU."""

import numpy as np
import pytest
import torch
from scipy import signal as sig

import radiocore_tpu as jrc
from radiocore_tpu_torch import Channel, Tuner

torch.set_num_threads(2)

REL_MAX = 1e-5   # the port against the JAX Tuner, relative L2 per channel


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


PLANS = [
    # (channels (frequency, bandwidth), requested bandwidth or None)
    ([(96.9e6, 240e3), (94.5e6, 240e3), (97.5e6, 240e3)], None),
    ([(100.0e6, 200e3)], 2e6),
    ([(1e6, 100e3), (2e6, 200e3)], None),
    ([(88.1e6, 170e3), (88.3e6, 190e3), (107.9e6, 240e3)], 25e6),
    ([(96.9e6 + i * 400e3, 240e3) for i in range(7)], 10e6),
]


@pytest.mark.parametrize("plan,wanted", PLANS)
def test_band_plan_equals_jax(plan, wanted):
    """Centre, width and every channel's edges equal the JAX Tuner's to
    the digit (the same float arithmetic in the same order)."""
    tuners = [Tuner(device="cpu"), jrc.Tuner()]
    for t in tuners:
        for f, bw in plan:
            t.add_channel(f, bw, None)
        if wanted:
            t.request_bandwidth(wanted)
    mine, theirs = tuners
    assert mine.input_frequency == theirs.input_frequency
    assert mine.input_bandwidth == theirs.input_bandwidth
    for a, b in zip(mine.channels(), theirs.channels()):
        assert (a.index, a.bandwidth, a.lower_frequency, a.center_frequency,
                a.higher_frequency, a.address_bytes) == (
            b.index, b.bandwidth, b.lower_frequency, b.center_frequency,
            b.higher_frequency, b.address_bytes)
        assert mine._shift(a) == theirs._shift(b)


def test_band_plan_recalculation():
    """Center/width from channel extremes, padded to mean-bw multiple
    (reference: tuner.py:163-174)."""
    tuner = Tuner(device="cpu")
    tuner.add_channel(96.9e6, 240e3, None)
    tuner.add_channel(94.5e6, 240e3, None)
    tuner.add_channel(97.5e6, 240e3, None)
    lo = 94.5e6 - 120e3
    hi = 97.5e6 + 120e3
    assert tuner.input_frequency == (lo + hi) / 2
    span = hi - lo
    padded = span + (-span) % 240e3
    assert tuner.input_bandwidth == padded
    assert padded % 240e3 == 0


def test_request_bandwidth_upward_only():
    tuner = Tuner(device="cpu")
    tuner.add_channel(100.0e6, 200e3, None)
    with pytest.raises(ValueError):
        tuner.request_bandwidth(100e3)
    tuner.request_bandwidth(2e6)
    assert tuner.input_bandwidth == 2e6


def test_channel_address_bytes():
    ch = Channel(0, 240e3, None, 0, 96.9e6, 0)
    assert ch.address_bytes == int(96.9e6).to_bytes(4, "little")


def test_reset_and_run_before_load():
    tuner = Tuner(device="cpu")
    tuner.add_channel(1e6, 100e3, None)
    with pytest.raises(ValueError):
        tuner.run(0)
    with pytest.raises(ValueError):
        tuner.run_all()
    tuner.reset()
    assert tuner.channels() == [] and tuner.input_bandwidth == 0.0


def test_tuner_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        Tuner()


def _tone_band(n, offsets_hz, tone_offsets_hz):
    """Full band: per channel, a complex tone near each channel center."""
    t = np.arange(n) / n  # 1 second
    band = np.zeros(n, np.complex128)
    for off, toff in zip(offsets_hz, tone_offsets_hz):
        band += np.exp(2j * np.pi * (off + toff) * t)
    return band


def test_run_extracts_tone_at_offset():
    """A tone 5 kHz above a channel's center appears at +5 kHz baseband."""
    n = 1_000_000
    bw = 100_000
    tuner = Tuner(device="cpu")
    center = 500_000_000
    tuner.add_channel(center - 200_000, bw, None)
    tuner.add_channel(center + 200_000, bw, None)
    tuner.request_bandwidth(n)

    tuner.load(_tone_band(n, [-200_000, 200_000], [5_000, -12_000]))
    ch0 = tuner.run(0).numpy()
    assert ch0.shape == (bw,)
    assert np.argmax(np.abs(np.fft.fft(ch0))) == 5_000
    ch1 = tuner.run(1).numpy()
    assert np.argmax(np.abs(np.fft.fft(ch1))) == bw - 12_000


def test_run_matches_scipy_reference_path():
    """Per-channel run == roll + windowed freq-domain scipy resample."""
    n = 200_000
    bw = 20_000
    tuner = Tuner(device="cpu")
    c0 = 50_000_000
    tuner.add_channel(c0 - 40_000, bw, None)
    tuner.add_channel(c0 + 40_000, bw, None)
    tuner.request_bandwidth(n)

    rng = np.random.default_rng(0)
    band = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    tuner.load(band)

    win = np.fft.fftshift(sig.get_window("hann", n))
    X = np.fft.fft(band.astype(np.complex64).astype(np.complex128))
    for i, ch in enumerate(tuner.channels()):
        shift = int(tuner.input_frequency - ch.center_frequency)
        want = sig.resample(np.roll(X, shift) * win, bw, domain="freq")
        got = tuner.run(i).numpy()
        np.testing.assert_allclose(got, want,
                                   atol=3e-4 * np.max(np.abs(want)))


# (band n, channel offsets from the band centre, bandwidth): the JAX
# test's two plans, a uniform power-of-two plan that tiles the band (the
# layout K-EXTRACT takes on the card) and three stations that fill a
# band that is not a power of two.
EXTRACT_PLANS = [
    (200_000, (-60_000, -20_000, 20_000, 60_000), 20_000),
    (1_000_000, (-200_000, 200_000), 100_000),
    (1 << 16, tuple(-(1 << 15) + (1 << 12) + i * (1 << 13)
                    for i in range(8)), 1 << 13),
    (96_000, (-32_000, 0, 32_000), 32_000),
]


def _loaded_pair(n, offsets, bw, seed):
    c0 = 50_000_000
    tuners = [Tuner(device="cpu"), jrc.Tuner()]
    for t in tuners:
        for off in offsets:
            t.add_channel(c0 + off, bw, None)
        t.request_bandwidth(n)
    rng = np.random.default_rng(seed)
    band = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for t in tuners:
        t.load(band)
    return tuners


@pytest.mark.parametrize("n,offsets,bw", EXTRACT_PLANS)
def test_run_all_and_run_match_jax(n, offsets, bw):
    """``run_all`` and every ``run(i)`` within 1e-5 relative L2 of the JAX
    Tuner's on the same band."""
    mine, theirs = _loaded_pair(n, offsets, bw, seed=len(offsets))
    assert int(mine.input_bandwidth) == n
    got_all = mine.run_all()
    assert got_all.dtype == torch.complex64
    assert tuple(got_all.shape) == (len(offsets), bw)
    want_all = np.asarray(theirs.run_all())
    for i in range(len(offsets)):
        assert _rel(got_all[i].numpy(), want_all[i]) < REL_MAX, i
        got = mine.run(i)
        assert got.dtype == torch.complex64
        assert _rel(got.numpy(), np.asarray(theirs.run(i))) < REL_MAX, i


def test_run_all_matches_run():
    n = 200_000
    bw = 20_000
    tuner = Tuner(device="cpu")
    c0 = 50_000_000
    for off in (-60_000, -20_000, 20_000, 60_000):
        tuner.add_channel(c0 + off, bw, None)
    tuner.request_bandwidth(n)

    rng = np.random.default_rng(1)
    tuner.load(rng.standard_normal(n) + 1j * rng.standard_normal(n))

    batched = tuner.run_all().numpy()
    assert batched.shape == (4, bw)
    for i in range(4):
        np.testing.assert_allclose(batched[i], tuner.run(i).numpy(),
                                   atol=1e-5)


def test_run_all_rejects_heterogeneous():
    tuner = Tuner(device="cpu")
    tuner.add_channel(1e6, 100e3, None)
    tuner.add_channel(2e6, 200e3, None)
    tuner.load(np.zeros(int(tuner.input_bandwidth), np.complex64))
    with pytest.raises(ValueError):
        tuner.run_all()


def test_load_takes_a_device_tensor_without_copy():
    """A complex64 tensor already on the tuner's device goes to the FFT
    as it is; the window is cached per (n, device)."""
    from radiocore_tpu_torch.runtime.transfer import to_device_c64

    tuner = Tuner(device="cpu")
    tuner.add_channel(0.0, 1000, None)
    band = torch.ones(4000, dtype=torch.complex64)
    assert to_device_c64(band, tuner.device) is band
    tuner.load(band)
    tuner.run(0)
    tuner.run(0)
    assert list(tuner._win_cache) == [(4000, torch.device("cpu"))]

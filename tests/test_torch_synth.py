"""The port's synthesis and measurement (``ops/synth.py``) against
``tests/test_synth.py``: the same calls through the JAX functions, and
the float64 host oracles, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracles
from radiocore_tpu.ops import synth as jsynth
from radiocore_tpu_torch.ops import synth

torch.set_num_threads(2)

FS, AUDIO = 250_000, 48_000
# fm_modulate against float64: the float32 cumsum of a 262 144-sample
# multiplex drifts by ~6e-5 on the CPU (the JAX package's own float32
# phase by 1.2e-4); the card sums in another order. 5e-4 is the limit.
FM_F64_MAX = 5e-4


@pytest.mark.parametrize("f", [19e3, 38e3, 440.0, 1000.0])
def test_sin_tone_precision(f):
    """Split-phase tone matches float64 to < 1e-3 over 1 s and the JAX
    tone to a few float32 ulps."""
    n = FS
    dev = synth._sin_tone(n, f, FS, device="cpu").numpy()
    ref = np.sin(2 * np.pi * f * np.arange(n, dtype=np.float64) / FS)
    assert np.max(np.abs(dev - ref)) < 1e-3, f
    np.testing.assert_allclose(dev, np.asarray(jsynth._sin_tone(n, f, FS)),
                               rtol=0, atol=2.5e-7)


def test_sin_tone_chunk_continuation():
    """k0 continuation equals one long generation."""
    n = 8192
    whole = synth._sin_tone(2 * n, 19e3, FS, device="cpu").numpy()
    a = synth._sin_tone(n, 19e3, FS, k0=0, device="cpu").numpy()
    b = synth._sin_tone(n, 19e3, FS, k0=n, device="cpu").numpy()
    assert np.allclose(np.concatenate([a, b]), whole, atol=1e-6)


@pytest.mark.parametrize("k0", [0, 123_457])
def test_stereo_multiplex_matches_jax_and_oracle(k0):
    n = 65_536
    got = synth.stereo_multiplex(n, FS, 440.0, 1000.0, k0=k0,
                                 device="cpu")
    assert got.dtype == torch.float32
    want = np.asarray(jsynth.stereo_multiplex(n, FS, 440.0, 1000.0, k0=k0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if k0 == 0:
        ref = oracles.make_stereo_multiplex(n, FS, 440.0, 1000.0)
        assert np.max(np.abs(got.numpy() - ref)) < 2e-3


def test_fm_modulate_against_float64_oracle():
    """The float32 cumsum against float64 with a stated limit."""
    n = 262_144
    mpx = oracles.make_stereo_multiplex(n, n, 440.0, 1000.0)
    iq, end = synth.fm_modulate(torch.from_numpy(mpx.astype(np.float32)),
                                0.25)
    assert iq.dtype == torch.complex64 and tuple(iq.shape) == (n,)
    ref = oracles.make_fm_iq(mpx.astype(np.float32).astype(np.float64), 0.25)
    assert np.max(np.abs(iq.numpy() - ref)) < FM_F64_MAX
    ref_end = np.pi * 0.25 * np.sum(mpx.astype(np.float32), dtype=np.float64)
    assert abs(float(end) - ref_end) < FM_F64_MAX


def test_fm_modulate_phase_continuation():
    """Two chunks chained through ``end_phase`` equal one long chunk."""
    rng = np.random.default_rng(3)
    msg = torch.from_numpy(rng.uniform(-1, 1, 8192).astype(np.float32))
    whole, _ = synth.fm_modulate(msg)
    a, end = synth.fm_modulate(msg[:4096])
    b, _ = synth.fm_modulate(msg[4096:], phase0=end)
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), whole.numpy(),
                               atol=5e-5)
    want, _ = jsynth.fm_modulate(jnp.asarray(msg.numpy()))
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), atol=5e-5)


def test_stereo_fm_iq_matches_jax_and_oracle():
    n = 262_144
    got = synth.stereo_fm_iq(n, float(n), 440.0, 1000.0, device="cpu")
    assert got.dtype == torch.complex64
    ref = oracles.make_fm_iq(
        oracles.make_stereo_multiplex(n, n, 440.0, 1000.0), 0.25)
    assert np.max(np.abs(got.numpy() - ref)) < FM_F64_MAX
    want = np.asarray(jsynth.stereo_fm_iq(n, float(n), 440.0, 1000.0))
    assert np.max(np.abs(got.numpy() - want)) < FM_F64_MAX


def test_stereo_fm_iq_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        synth.stereo_fm_iq(1024, 1024.0, 100.0, 200.0)


@pytest.mark.parametrize("noise", [0.01, 0.1])
def test_device_tone_snr_matches_jax_and_host(noise):
    """Within 0.01 dB of the JAX measurement on the same input, and within
    1 dB of the float64 host oracle. (At 43 dB SNR and more, the two
    packages' float32 ``sum − tone`` cancellation alone differs by
    ~0.015 dB, so the inputs stay below it.)"""
    n = 65536
    x = synth._sin_tone(n, 1000.0, AUDIO, device="cpu").numpy()
    x = x + noise * np.random.default_rng(0).standard_normal(n).astype(
        np.float32)
    got = synth.tone_snr_db(torch.from_numpy(x), AUDIO, 1000.0,
                            n_fft=32768, skip=2048)
    assert got.dim() == 0
    want = float(jsynth.tone_snr_db(jnp.asarray(x), AUDIO, 1000.0,
                                    n_fft=32768, skip=2048))
    assert float(got) == pytest.approx(want, abs=0.01)
    host = oracles.tone_snr_db(x[2048:2048 + 32768], AUDIO, 1000.0)
    assert float(got) == pytest.approx(host, abs=1.0)


def test_device_synth_wbfm_end_to_end():
    """Synthesized IQ → the port's WBFM step → device SNR: the full
    transfer-free drive, on the CPU here."""
    from radiocore_tpu_torch.models.wbfm import make_wbfm_step, wbfm_init_state

    iq = synth.stereo_fm_iq(FS, float(FS), 440.0, 1000.0, device="cpu")
    step = make_wbfm_step(FS, AUDIO)
    state = wbfm_init_state(AUDIO, device="cpu")
    audio, state = step(iq, state)
    assert tuple(audio.shape) == (AUDIO, 2)

    snr_l = float(synth.tone_snr_db(audio[:, 0], AUDIO, 440.0))
    snr_r = float(synth.tone_snr_db(audio[:, 1], AUDIO, 1000.0))
    leak_l_in_r = float(synth.tone_snr_db(audio[:, 1], AUDIO, 440.0))
    assert snr_l > 20.0, snr_l
    assert snr_r > 20.0, snr_r
    assert leak_l_in_r < snr_r - 10.0, (leak_l_in_r, snr_r)

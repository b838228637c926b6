"""The port's demodulator family (models/) against the JAX package's on
the signals of tests/oracles.py at 100 000 → 20 000: every class and
every ``make_*_step`` on the same seeded input, the audio within 4e-5
abs (the bound of tests/test_pipeline_pallas.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracles

torch.set_num_threads(2)

FS = 100_000     # one-second convention: input_size == sample rate
AUDIO = 20_000
ATOL = 4e-5      # audio, port against the JAX package
# The nco loop's subcarrier differs by the two packages' float32 cos and
# sin (≈ 1e-6 rad of phase at lock); the audio stays inside the same
# bound.
ATOL_NCO = 4e-5


def _wbfm_iq(seconds: int = 1, fs: int = FS):
    mpx = oracles.make_stereo_multiplex(fs * seconds, fs, 440.0, 1000.0)
    return oracles.make_fm_iq(mpx, deviation_gain=0.25).astype(np.complex64)


def _tmodels():
    from radiocore_tpu_torch import models
    return models


# ---- WBFM ---------------------------------------------------------------

@pytest.mark.parametrize("pll", ["analytic", "nco"])
def test_wbfm_exact_step_matches_jax(pll):
    """Two stations, one chunk, from the initial state."""
    from radiocore_tpu.models import wbfm as jw
    from radiocore_tpu_torch.models import wbfm as tw
    iq = np.stack([_wbfm_iq(), oracles.make_fm_iq(
        oracles.make_stereo_multiplex(FS, FS, 700.0, 300.0), 0.25)]).astype(
            np.complex64)
    want, st_j = jax.jit(jax.vmap(jw.make_wbfm_step(FS, AUDIO, pll=pll)))(
        jnp.asarray(iq), jw.wbfm_init_state(AUDIO, batch_shape=(2,), pll=pll))
    got, st_t = tw.make_wbfm_step(FS, AUDIO, pll=pll)(
        torch.from_numpy(iq),
        tw.wbfm_init_state(AUDIO, batch_shape=(2,), pll=pll, device="cpu"))
    assert tuple(got.shape) == (2, AUDIO, 2) and got.dtype == torch.float32
    atol = ATOL_NCO if pll == "nco" else ATOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)
    assert set(st_t) == set(st_j)
    for key in ("deemph_l", "deemph_r"):
        np.testing.assert_allclose(st_t[key].numpy(), np.asarray(st_j[key]),
                                   atol=atol)
    if pll == "nco":
        d = (st_t["pll"].phase.numpy().astype(np.float64)
             - np.asarray(st_j["pll"].phase) + np.pi) % (2 * np.pi) - np.pi
        assert np.abs(d).max() <= 1e-4
        np.testing.assert_allclose(st_t["pll"].freq.numpy(),
                                   np.asarray(st_j["pll"].freq), atol=1e-7)


def test_wbfm_class_streams_three_chunks_like_jax():
    import radiocore_tpu as rc
    iq = _wbfm_iq(seconds=3).reshape(3, FS)
    ref = rc.WBFM(FS, AUDIO)
    port = _tmodels().WBFM(FS, AUDIO, device="cpu")
    for chunk in iq:
        want = ref.run(chunk)
        got = port.run(chunk)
        assert isinstance(got, np.ndarray) and got.shape == (AUDIO, 2)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL)
    # numpy_output=False keeps the audio a tensor on the model's device.
    out = port.run(iq[0], numpy_output=False)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


def test_wbfm_class_takes_lists_and_tensors_and_the_cuda_argument():
    port = _tmodels().WBFM(FS, AUDIO, cuda=True, mode="fast", device="cpu")
    iq = _wbfm_iq()
    a = port.run(iq)
    b = _tmodels().WBFM(FS, AUDIO, mode="fast", device="cpu").run(
        torch.from_numpy(iq))
    np.testing.assert_array_equal(a, b)


def test_wbfm_matches_oracle_streaming():
    """Two consecutive chunks against the float64 scipy oracle."""
    iq = _wbfm_iq(seconds=2).reshape(2, FS)
    wbfm = _tmodels().WBFM(FS, AUDIO, device="cpu")
    state = None
    for i in range(2):
        want, state = oracles.wbfm(iq[i].astype(np.complex128), FS, AUDIO,
                                   state=state)
        got = wbfm.run(iq[i])
        for ch in range(2):
            assert oracles.snr_db(want[:, ch], got[:, ch]) > 40, (i, ch)


def test_wbfm_stereo_separation():
    audio = _tmodels().WBFM(FS, AUDIO, device="cpu").run(_wbfm_iq())
    l, r = audio[1000:-1000, 0], audio[1000:-1000, 1]
    assert oracles.tone_snr_db(l, AUDIO, 440.0) > 10
    assert oracles.tone_snr_db(r, AUDIO, 1000.0) > 10
    assert (oracles.tone_snr_db(l, AUDIO, 440.0)
            - oracles.tone_snr_db(l, AUDIO, 1000.0)) > 10
    assert (oracles.tone_snr_db(r, AUDIO, 1000.0)
            - oracles.tone_snr_db(r, AUDIO, 440.0)) > 10


@pytest.mark.parametrize("fs,audio,edge", [(FS, AUDIO, 500),
                                           (262_144, 49_152, 1000)])
def test_wbfm_fast_mode_matches_exact(fs, audio, edge):
    """mode='fast' against mode='exact' in the port: > 60 dB on the
    interior (the edges differ by design: circular against odd
    extension), at the small shape and at the 262 144 → 49 152 shape."""
    from radiocore_tpu_torch.models.wbfm import (make_wbfm_step,
                                                 wbfm_init_state)
    iq = torch.from_numpy(_wbfm_iq(fs=fs))
    a_e, _ = make_wbfm_step(fs, audio, mode="exact")(
        iq, wbfm_init_state(audio, device="cpu"))
    a_f, _ = make_wbfm_step(fs, audio, mode="fast")(
        iq, wbfm_init_state(audio, device="cpu"))
    a_e, a_f = a_e.numpy(), a_f.numpy()
    for ch in range(2):
        snr = oracles.snr_db(a_e[edge:-edge, ch], a_f[edge:-edge, ch])
        assert snr > 60, snr
    assert oracles.tone_snr_db(a_f[2 * edge:-2 * edge, 0], audio, 440.0) > 10
    assert oracles.tone_snr_db(a_f[2 * edge:-2 * edge, 1], audio, 1000.0) > 10


def test_wbfm_nco_pll_beats_analytic_on_noisy_pilot():
    """pll='nco' (50 Hz loop bandwidth) rejects pilot-band noise that the
    analytic-signal path passes into the 38 kHz subcarrier's phase."""
    from radiocore_tpu_torch.models.wbfm import (make_wbfm_step,
                                                 wbfm_init_state)
    rng = np.random.default_rng(5)
    mpx = oracles.make_stereo_multiplex(FS, FS, 440.0, 1000.0)
    z = np.zeros(FS // 2 + 1, complex)
    lo, hi = 18_500, 19_500  # noise in the pilot bandpass only
    z[lo:hi] = rng.standard_normal(hi - lo) + 1j * rng.standard_normal(hi - lo)
    noise = np.fft.irfft(z, FS)
    noise *= 0.03 / np.sqrt(np.mean(noise ** 2))
    iq = torch.from_numpy(
        oracles.make_fm_iq(mpx + noise, 0.25).astype(np.complex64))
    snrs = {}
    for pll in ("analytic", "nco"):
        audio, state = make_wbfm_step(FS, AUDIO, pll=pll)(
            iq, wbfm_init_state(AUDIO, pll=pll, device="cpu"))
        a = audio.numpy()
        snrs[pll] = min(oracles.tone_snr_db(a[1000:-1000, 0], AUDIO, 440.0),
                        oracles.tone_snr_db(a[1000:-1000, 1], AUDIO, 1000.0))
        assert ("pll" in state) == (pll == "nco")
    assert snrs["nco"] > 30, snrs
    assert snrs["nco"] > snrs["analytic"] + 10, snrs


def test_wbfm_default_mode_is_exact():
    """Leaving ``mode`` out runs ``exact`` in both packages."""
    from radiocore_tpu.models import wbfm as jw
    from radiocore_tpu_torch.models import wbfm as tw
    iq = _wbfm_iq()
    got, _ = tw.make_wbfm_step(FS, AUDIO)(
        torch.from_numpy(iq), tw.wbfm_init_state(AUDIO, device="cpu"))
    exact, _ = tw.make_wbfm_step(FS, AUDIO, mode="exact")(
        torch.from_numpy(iq), tw.wbfm_init_state(AUDIO, device="cpu"))
    want, _ = jax.jit(jw.make_wbfm_step(FS, AUDIO))(
        jnp.asarray(iq), jw.wbfm_init_state(AUDIO))
    assert torch.equal(got, exact)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kwargs", [
    dict(mode="turbo"), dict(pll="costas"), dict(mode="fast", pll="nco"),
    dict(mode="fast_spec", pll="nco"), dict(mode="turbo", pll="nco"),
])
def test_wbfm_unknown_mode_or_pll_raises_value_error(kwargs):
    """As the reference: ``ValueError`` for an unknown ``mode`` or ``pll``
    and for ``pll='nco'`` outside the exact mode, from ``make_wbfm_step``
    and from the class."""
    from radiocore_tpu.models import wbfm as jw
    from radiocore_tpu_torch.models import wbfm as tw
    with pytest.raises(ValueError):
        jw.make_wbfm_step(FS, AUDIO, **kwargs)
    with pytest.raises(ValueError):
        tw.make_wbfm_step(FS, AUDIO, **kwargs)
    with pytest.raises(ValueError):
        tw.WBFM(FS, AUDIO, device="cpu", **kwargs)


@pytest.mark.parametrize("n,m", [(FS, AUDIO), (262_144, 49_152)])
def test_dead_channel_fast_is_finite_and_exact_is_nan_as_in_jax(n, m):
    """Zero IQ: fast mode gives finite audio equal to the JAX package's,
    exact mode NaN in both."""
    from radiocore_tpu.models import wbfm as jw
    from radiocore_tpu_torch.models import wbfm as tw
    zj, zt = jnp.zeros(n, jnp.complex64), torch.zeros(n, dtype=torch.complex64)
    want, _ = jax.jit(jw.make_wbfm_step(n, m, mode="fast"))(
        zj, jw.wbfm_init_state(m))
    got, _ = tw.make_wbfm_step(n, m, mode="fast")(
        zt, tw.wbfm_init_state(m, device="cpu"))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want, _ = jax.jit(jw.make_wbfm_step(n, m, mode="exact"))(
        zj, jw.wbfm_init_state(m))
    got, _ = tw.make_wbfm_step(n, m, mode="exact")(
        zt, tw.wbfm_init_state(m, device="cpu"))
    assert np.isnan(np.asarray(want)).all() and bool(torch.isnan(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               equal_nan=True)


# ---- FM, MFM --------------------------------------------------------------

def test_fm_step_and_class_match_jax_and_oracle():
    import radiocore_tpu as rc
    from radiocore_tpu.models.fm import make_fm_step as jax_fm
    msg = 0.5 * np.sin(2 * np.pi * 440 * np.arange(FS) / FS)
    iq = oracles.make_fm_iq(msg).astype(np.complex64)
    got = _tmodels().FM(FS, AUDIO, device="cpu").run(iq)
    assert got.shape == (AUDIO, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, rc.FM(FS, AUDIO).run(iq), atol=ATOL)
    want = oracles.decimate(oracles.fm_demod(iq.astype(np.complex128)), AUDIO)
    assert oracles.snr_db(want, got[:, 0]) > 40
    both = np.stack([iq, _wbfm_iq()])
    np.testing.assert_allclose(
        _tmodels().make_fm_step(FS, AUDIO)(torch.from_numpy(both)).numpy(),
        np.asarray(jax_fm(FS, AUDIO)(jnp.asarray(both))), atol=ATOL)


def test_fm_equal_sizes_still_windows():
    from radiocore_tpu.models.fm import make_fm_step as jax_fm
    iq = _wbfm_iq()[:4000]
    np.testing.assert_allclose(
        _tmodels().make_fm_step(4000, 4000)(torch.from_numpy(iq)).numpy(),
        np.asarray(jax_fm(4000, 4000)(jnp.asarray(iq))), atol=ATOL)


def test_mfm_class_streams_like_jax_and_matches_oracle():
    import radiocore_tpu as rc
    iq = _wbfm_iq(seconds=3).reshape(3, FS)
    ref, port = rc.MFM(FS, AUDIO), _tmodels().MFM(FS, AUDIO, device="cpu")
    for i, chunk in enumerate(iq):
        got = port.run(chunk)
        assert got.shape == (AUDIO, 1)
        np.testing.assert_allclose(got, ref.run(chunk), atol=ATOL)
        if i == 0:
            want, _ = oracles.mfm(chunk.astype(np.complex128), FS, AUDIO)
            assert oracles.snr_db(want, got[:, 0]) > 40


def test_mfm_step_batched_matches_jax():
    from radiocore_tpu.models import mfm as jm
    from radiocore_tpu_torch.models import mfm as tm
    iq = _wbfm_iq(seconds=2).reshape(2, FS)
    want, st_j = jax.jit(jax.vmap(jm.make_mfm_step(FS, AUDIO)))(
        jnp.asarray(iq), jm.mfm_init_state(AUDIO, batch_shape=(2,)))
    got, st_t = tm.make_mfm_step(FS, AUDIO)(
        torch.from_numpy(iq),
        tm.mfm_init_state(AUDIO, batch_shape=(2,), device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(st_t["deemph"].numpy(),
                               np.asarray(st_j["deemph"]), atol=ATOL)


# ---- the filter classes -----------------------------------------------------

@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_decimate_matches_jax(complex_):
    import radiocore_tpu as rc
    rng = np.random.default_rng(3)
    x = rng.standard_normal(6000).astype(np.float32)
    if complex_:
        x = (x + 1j * rng.standard_normal(6000)).astype(np.complex64)
    got = _tmodels().Decimate(6000, 1250, device="cpu").run(x)
    want = np.asarray(rc.Decimate(6000, 1250).run(x))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_bandpass_matches_jax(dtype):
    import radiocore_tpu as rc
    rng = np.random.default_rng(4)
    x = rng.standard_normal(FS).astype(np.float32)
    if dtype == "complex64":
        x = (x + 1j * rng.standard_normal(FS)).astype(np.complex64)
    ref = rc.Bandpass(FS, 19e3 - 50, 19e3 + 50, dtype=dtype, num_taps=41)
    port = _tmodels().Bandpass(FS, 19e3 - 50, 19e3 + 50, dtype=dtype,
                               num_taps=41, device="cpu")
    np.testing.assert_array_equal(port.taps, ref.taps)
    want = np.asarray(ref.run(x))
    got = port.run(x)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_deemphasis_class_streams_like_jax():
    import radiocore_tpu as rc
    rng = np.random.default_rng(5)
    ref = rc.Deemphasis(AUDIO)
    port = _tmodels().Deemphasis(AUDIO, device="cpu")
    for _ in range(3):
        x = rng.standard_normal(AUDIO).astype(np.float32)
        np.testing.assert_allclose(port.run(x).numpy(),
                                   np.asarray(ref.run(x)), atol=1e-5)


def test_deemphasis_init_dtype():
    from radiocore_tpu_torch.ops.deemphasis import deemphasis_init
    _, hist = deemphasis_init(AUDIO, batch_shape=(2,), device="cpu")
    assert hist.dtype == torch.float32 and tuple(hist.shape) == (2, 50)
    _, hist = deemphasis_init(AUDIO, dtype=torch.float64, device="cpu")
    assert hist.dtype == torch.float64 and bool((hist == 1).all())
    port = _tmodels().Deemphasis(1000, dtype="float64", device="cpu")
    assert port.run(np.ones(1000)).dtype == torch.float64
    with pytest.raises(ValueError, match="dtype"):
        _tmodels().Deemphasis(1000, dtype="float33", device="cpu")


def test_pll_class_matches_jax():
    import radiocore_tpu as rc
    t = np.arange(FS) / FS
    pilot = np.sin(2 * np.pi * 19e3 * t + 0.4).astype(np.float32)
    ref, port = rc.PLL(), _tmodels().PLL(device="cpu")
    ref.step(pilot)
    port.step(pilot)
    for mult in (1.0, 2.0):
        np.testing.assert_allclose(port.real(mult).numpy(),
                                   np.asarray(ref.real(mult)), atol=2e-5)
        np.testing.assert_allclose(port.image(mult).numpy(),
                                   np.asarray(ref.image(mult)), atol=2e-5)


# ---- the classes' contracts ---------------------------------------------------

def test_channels_properties():
    m = _tmodels()
    assert m.FM(1000, 1000, device="cpu").channels == 1
    assert m.MFM(1000, 1000, device="cpu").channels == 1
    # WBFM needs Nyquist above the 19 kHz pilot.
    assert m.WBFM(48_000, 8000, device="cpu").channels == 2


@pytest.mark.parametrize("make", [
    lambda m: m.FM(1000, 200, device="cpu"),
    lambda m: m.MFM(1000, 200, device="cpu"),
    lambda m: m.WBFM(48_000, 8000, device="cpu"),
    lambda m: m.Decimate(1000, 200, device="cpu"),
    lambda m: m.Bandpass(1000, 100, 200, num_taps=21, device="cpu"),
    lambda m: m.Deemphasis(1000, device="cpu"),
], ids=["FM", "MFM", "WBFM", "Decimate", "Bandpass", "Deemphasis"])
def test_run_checks_the_length(make):
    with pytest.raises(ValueError, match="size"):
        make(_tmodels()).run(np.zeros(999, np.complex64))


def test_models_export_the_reference_names():
    import radiocore_tpu.models as jm
    import radiocore_tpu_torch
    assert _tmodels().__all__ == jm.__all__
    for name in jm.__all__:
        assert getattr(radiocore_tpu_torch, name) is getattr(_tmodels(), name)


def test_classes_need_a_card_unless_told_the_cpu():
    """``device=None`` is the first CUDA device: without one the classes
    raise and name the missing device, never running on the CPU
    unasked."""
    if torch.cuda.is_available():
        assert _tmodels().FM(1000, 200)._device.type == "cuda"
        return
    for make in (lambda m: m.FM(1000, 200), lambda m: m.PLL(),
                 lambda m: m.WBFM(48_000, 8000)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make(_tmodels())


def test_transfer_round_trip():
    from radiocore_tpu_torch.runtime.transfer import (to_device_c64,
                                                      to_device_f32, to_host)
    c = to_device_c64([1.0, 2.0], "cpu")
    assert c.dtype == torch.complex64 and c.tolist() == [1 + 0j, 2 + 0j]
    c = to_device_c64(np.array([1 + 2j], np.complex128), "cpu")
    assert c.dtype == torch.complex64
    f = to_device_f32(np.arange(3), "cpu")
    assert f.dtype == torch.float32
    assert to_device_f32(f, "cpu") is f or torch.equal(to_device_f32(f, "cpu"),
                                                       f)
    out = to_host(c)
    assert isinstance(out, np.ndarray) and out.dtype == np.complex64
    assert to_host([1, 2]).tolist() == [1, 2]

"""The port's fused multi-station step against the JAX one, end to end on
the CPU: the same band chunks (numpy, seeded) through both, over three
chained chunks from the same non-trivial de-emphasis state (carried
across with ``state_from_numpy``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import make_fm_iq, make_stereo_multiplex

torch.set_num_threads(2)

# (stations, station_chunk, audio_chunk). 4 × 65 536 takes the legacy
# tail (its 38 kHz slice runs past Nyquist); 2 × 262 144 takes the
# envelope tail, as the 64 × 262 144 main plan does; 3 × 65 536 is a
# band that is not a power of two, as the 96-station band is.
PLANS = [(4, 65_536, 16_384), (2, 262_144, 49_152), (3, 65_536, 16_384)]


def _offsets(c, sc):
    half = c * sc // 2 - sc // 2
    return [int(-half + i * sc) for i in range(c)]


def _fm_band(rng, c, sc):
    """Band chunk carrying one FM stereo station per slot (the same
    tones every chunk) plus fresh noise."""
    n = c * sc
    spec = np.zeros(n, np.complex128)
    k = (np.fft.fftfreq(sc) * sc).astype(np.int64)
    for i, off in enumerate(_offsets(c, sc)):
        mpx = make_stereo_multiplex(sc, sc, 300.0 + 200 * i, 1100.0 + 300 * i)
        iq = make_fm_iq(mpx, 0.25)
        spec[(off + k) % n] += np.fft.fft(iq) * (n / sc)
    band = np.fft.ifft(spec)
    band += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return band.astype(np.complex64)


# The bands carry constant-envelope FM, as real stations do. A band of
# pure noise puts IQ samples near zero and phase steps near ±π, where the
# quadrature demod turns the FFTs' last-bit differences (pocketfft in XLA
# and in torch round differently, ~4e-7 relative on the band spectrum)
# into audio jumps: a 3e-6 relative perturbation of a noise band's
# spectrum moved its audio by 0.16, against 6e-8 for an FM band
# (measured on the CPU, 8 x 262 144 plan). FM keeps the comparison about
# the pipeline and holds the 4e-5 bound of tests/test_pipeline_pallas.py.
ATOL = 4e-5


@pytest.mark.parametrize("c,sc,ac", PLANS)
def test_fast_step_matches_jax(c, sc, ac):
    from radiocore_tpu.parallel.pipeline import (
        make_multi_station_step as jax_step)
    from radiocore_tpu_torch.parallel.pipeline import (
        make_multi_station_step as torch_step)
    from radiocore_tpu_torch.runtime.checkpoint import (state_from_numpy,
                                                        state_to_numpy)

    n = c * sc
    offs = _offsets(c, sc)
    step_j, state_j = jax_step(n, offs, sc, ac, mode="fast")
    step_t, state_t = torch_step(n, offs, sc, ac, mode="fast", device="cpu")
    assert set(state_t) == set(state_j)

    rng = np.random.default_rng(5)
    hist = {k: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in state_j.items()}
    state_j = {k: jnp.asarray(v) for k, v in hist.items()}
    state_t = state_from_numpy(hist, "cpu")

    for _ in range(3):
        band = _fm_band(rng, c, sc)
        want, state_j = step_j(jnp.asarray(band), state_j)
        got, state_t = step_t(torch.from_numpy(band), state_t)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (c, ac, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        got_state = state_to_numpy(state_t)
        for key, ref in state_j.items():
            np.testing.assert_allclose(got_state[key], np.asarray(ref),
                                       atol=ATOL)


@pytest.mark.parametrize("c,sc,ac", PLANS[:2])
@pytest.mark.parametrize("xd", ["fused", "spec"])
def test_extract_demod_step_matches_jax(xd, c, sc, ac, monkeypatch):
    """``extract_demod=`` against the JAX step with
    RADIOCORE_TPU_EXTRACT_DEMOD set (its Pallas kernels in interpret
    mode), over three chained chunks from a non-trivial state."""
    from radiocore_tpu.parallel.pipeline import (
        make_multi_station_step as jax_step)
    from radiocore_tpu_torch.parallel.pipeline import (
        make_multi_station_step as torch_step)
    from radiocore_tpu_torch.runtime.checkpoint import (state_from_numpy,
                                                        state_to_numpy)

    monkeypatch.setenv("RADIOCORE_TPU_EXTRACT_DEMOD", xd)
    n = c * sc
    offs = _offsets(c, sc)
    step_j, state_j = jax_step(n, offs, sc, ac, mode="fast")
    step_t, _ = torch_step(n, offs, sc, ac, mode="fast", extract_demod=xd,
                           device="cpu")
    assert set(step_t.stages) == {"band_fft", "extract_demod", "tail"}

    rng = np.random.default_rng(6)
    hist = {k: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in state_j.items()}
    state_j = {k: jnp.asarray(v) for k, v in hist.items()}
    state_t = state_from_numpy(hist, "cpu")

    for _ in range(3):
        band = _fm_band(rng, c, sc)
        want, state_j = step_j(jnp.asarray(band), state_j)
        got, state_t = step_t(torch.from_numpy(band), state_t)
        assert tuple(got.shape) == (c, ac, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        got_state = state_to_numpy(state_t)
        for key, ref in state_j.items():
            np.testing.assert_allclose(got_state[key], np.asarray(ref),
                                       atol=ATOL)


@pytest.mark.parametrize("xd", ["fused", "spec"])
def test_extract_demod_stages_compose_to_step(xd):
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    c, sc, ac = PLANS[0]
    step, state = make_multi_station_step(c * sc, _offsets(c, sc), sc, ac,
                                          mode="fast", extract_demod=xd,
                                          device="cpu")
    band = torch.from_numpy(_fm_band(np.random.default_rng(1), c, sc))
    want, _ = step(band, state)
    st = step.stages
    got, _ = st["tail"](st["extract_demod"](st["band_fft"](band)), state)
    assert torch.equal(got, want)


@pytest.mark.parametrize("xd,c,sc,offs", [
    ("spec", 4, 8192, None),             # m < 2^14: fails the A == C rule
    ("fused", 4, 65_536, [0, 70_000, -70_000, 140_000]),  # not uniform
    ("fused", 4, 65_536 + 2, None),      # m not a power of two
    ("bogus", 4, 65_536, None),
])
def test_extract_demod_unsupported_plan_raises(xd, c, sc, offs):
    """A plan the fused kernels do not take raises, naming it, where the
    JAX package would fall back to the default path in silence."""
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    offs = _offsets(c, sc) if offs is None else offs
    with pytest.raises(ValueError, match="extract_demod"):
        make_multi_station_step(c * sc, offs, sc, sc // 4, mode="fast",
                                extract_demod=xd, device="cpu")


def test_unknown_mode_raises_value_error():
    """An unknown ``mode`` is a ``ValueError``, as in the reference."""
    from radiocore_tpu.parallel.pipeline import (
        make_multi_station_step as jax_step)
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    args = (4 * 65_536, _offsets(4, 65_536), 65_536, 16_384)
    with pytest.raises(ValueError, match="mode"):
        jax_step(*args, mode="faster")
    with pytest.raises(ValueError, match="mode"):
        make_multi_station_step(*args, mode="faster", device="cpu")


@pytest.mark.parametrize("xd", ["fused", "spec"])
def test_exact_mode_takes_no_fused_route(xd):
    """The reference takes the fused routes for ``mode == 'fast'`` only;
    the port names the mismatch."""
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    with pytest.raises(ValueError, match="mode='fast'"):
        make_multi_station_step(4 * 65_536, _offsets(4, 65_536), 65_536,
                                16_384, mode="exact", extract_demod=xd,
                                device="cpu")
    with pytest.raises(ValueError, match="mode='fast'"):
        make_multi_station_step(4 * 65_536, _offsets(4, 65_536), 65_536,
                                16_384, extract_demod=xd, device="cpu")


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_stages_compose_to_step(mode):
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    c, sc, ac = PLANS[0]
    step, state = make_multi_station_step(c * sc, _offsets(c, sc), sc, ac,
                                          mode=mode, device="cpu")
    assert list(step.stages) == ["band_fft", "extract", "demod_tail"]
    band = torch.from_numpy(_fm_band(np.random.default_rng(1), c, sc))
    want, _ = step(band, state)
    st = step.stages
    got, _ = st["demod_tail"](st["extract"](st["band_fft"](band)), state)
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,sc,ac", PLANS)
def test_exact_step_matches_jax(c, sc, ac):
    """``mode="exact"`` (both packages' default, left out here) against
    the JAX step over three chained chunks from the same non-trivial
    de-emphasis state."""
    from radiocore_tpu.parallel.pipeline import (
        make_multi_station_step as jax_step)
    from radiocore_tpu_torch.parallel.pipeline import (
        make_multi_station_step as torch_step)
    from radiocore_tpu_torch.runtime.checkpoint import (state_from_numpy,
                                                        state_to_numpy)

    n = c * sc
    offs = _offsets(c, sc)
    step_j, state_j = jax_step(n, offs, sc, ac)
    step_t, _ = torch_step(n, offs, sc, ac, device="cpu")
    rng = np.random.default_rng(8)
    hist = {k: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in state_j.items()}
    state_j = {k: jnp.asarray(v) for k, v in hist.items()}
    state_t = state_from_numpy(hist, "cpu")
    for _ in range(3):
        band = _fm_band(rng, c, sc)
        want, state_j = step_j(jnp.asarray(band), state_j)
        got, state_t = step_t(torch.from_numpy(band), state_t)
        assert tuple(got.shape) == (c, ac, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        got_state = state_to_numpy(state_t)
        for key, ref in state_j.items():
            np.testing.assert_allclose(got_state[key], np.asarray(ref),
                                       atol=ATOL)

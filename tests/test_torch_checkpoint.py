"""State crosses between the packages, both ways: an npz written by
either package's ``save_state`` loads with the other's ``load_state``,
flat (de-emphasis histories) or nested (``pll="nco"``: a ``PLLState``
inside the dict), the keys equal letter for letter, and a stream resumed
from it continues with the same audio."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from oracles import make_fm_iq, make_stereo_multiplex

torch.set_num_threads(2)

# The reference's keys for ``wbfm_init_state(..., pll="nco")``.
NCO_KEYS = {"['deemph_l']", "['deemph_r']", "['pll']/.phase", "['pll']/.freq"}


def _jax_state(seed=0):
    rng = np.random.default_rng(seed)
    return {k: jnp.asarray(rng.standard_normal((4, 50)).astype(np.float32))
            for k in ("deemph_l", "deemph_r")}


def _nco_states(batch=(3,), seed=1):
    """The same random nco state as a JAX tree and as the port's."""
    from radiocore_tpu.models.wbfm import wbfm_init_state as jax_init
    from radiocore_tpu_torch.runtime.checkpoint import state_from_numpy
    rng = np.random.default_rng(seed)
    state_j = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.standard_normal(v.shape).astype(
            np.float32)), jax_init(16_384, batch_shape=batch, pll="nco"))
    return state_j, state_from_numpy(state_j, "cpu")


def test_jax_checkpoint_loads_in_port(tmp_path):
    from radiocore_tpu.runtime.checkpoint import save_state
    from radiocore_tpu_torch.models.wbfm import wbfm_init_state
    from radiocore_tpu_torch.runtime.checkpoint import (load_state,
                                                        state_to_numpy)
    state = _jax_state()
    path = str(tmp_path / "state.npz")
    save_state(path, state)
    like = wbfm_init_state(16_384, batch_shape=(4,), device="cpu")
    got = load_state(path, like)
    assert set(got) == set(state)
    for k, v in state_to_numpy(got).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(state[k]))


def test_load_state_checks_shape_and_keys(tmp_path):
    from radiocore_tpu.runtime.checkpoint import save_state
    from radiocore_tpu_torch.runtime.checkpoint import load_state
    path = str(tmp_path / "state.npz")
    save_state(path, _jax_state())
    with pytest.raises(ValueError):
        load_state(path, {"deemph_l": torch.zeros(3, 50)})
    with pytest.raises(KeyError):
        load_state(path, {"pll": torch.zeros(4, 50)})


@pytest.mark.parametrize("pll", ["analytic", "nco"])
def test_npz_keys_equal_the_reference_letter_for_letter(tmp_path, pll):
    from radiocore_tpu.models.wbfm import wbfm_init_state as jax_init
    from radiocore_tpu.runtime.checkpoint import save_state as jax_save
    from radiocore_tpu_torch.models.wbfm import wbfm_init_state
    from radiocore_tpu_torch.runtime.checkpoint import save_state
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jax_save(pj, jax_init(16_384, batch_shape=(2,), pll=pll))
    state = wbfm_init_state(16_384, batch_shape=(2,), pll=pll, device="cpu")
    save_state(pt, state)
    with np.load(pj) as dj, np.load(pt) as dt:
        assert set(dt.files) == set(dj.files)
        if pll == "nco":
            assert set(dt.files) == NCO_KEYS
        for key in dj.files:
            assert dt[key].dtype == dj[key].dtype
            np.testing.assert_array_equal(dt[key], dj[key])


@pytest.mark.parametrize("batch", [(), (3,)])
def test_nested_state_crosses_both_ways(tmp_path, batch):
    from radiocore_tpu.models.wbfm import wbfm_init_state as jax_init
    from radiocore_tpu.ops.nco_pll import PLLState as JaxPLLState
    from radiocore_tpu.runtime import checkpoint as jc
    from radiocore_tpu_torch.models.wbfm import wbfm_init_state
    from radiocore_tpu_torch.ops.nco_pll import PLLState
    from radiocore_tpu_torch.runtime import checkpoint as tc
    state_j, state_t = _nco_states(batch)
    assert isinstance(state_t["pll"], PLLState)
    like_t = wbfm_init_state(16_384, batch_shape=batch, pll="nco",
                             device="cpu")
    like_j = jax_init(16_384, batch_shape=batch, pll="nco")
    # JAX → port.
    path = str(tmp_path / "from_jax.npz")
    jc.save_state(path, state_j)
    got = tc.load_state(path, like_t)
    assert isinstance(got["pll"], PLLState)
    for key in ("deemph_l", "deemph_r"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(state_j[key]))
    for field in PLLState._fields:
        np.testing.assert_array_equal(getattr(got["pll"], field).numpy(),
                                      np.asarray(getattr(state_j["pll"],
                                                         field)))
    # Port → JAX.
    path = str(tmp_path / "from_port.npz")
    tc.save_state(path, state_t)
    back = jc.load_state(path, like_j)
    assert isinstance(back["pll"], JaxPLLState)
    for (kj, vj), (kb, vb) in zip(
            jax.tree_util.tree_flatten_with_path(state_j)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        assert kj == kb
        np.testing.assert_array_equal(np.asarray(vb), np.asarray(vj))
    # A nested entry that is missing or misshapen raises as a flat one.
    with pytest.raises(ValueError, match="pll"):
        tc.load_state(path, wbfm_init_state(16_384, batch_shape=batch + (2,),
                                            pll="nco", device="cpu")
                      | {"deemph_l": like_t["deemph_l"],
                         "deemph_r": like_t["deemph_r"]})
    flat = str(tmp_path / "flat.npz")
    tc.save_state(flat, {k: like_t[k] for k in ("deemph_l", "deemph_r")})
    with pytest.raises(KeyError, match="pll"):
        tc.load_state(flat, like_t)


def test_state_numpy_round_trip_keeps_the_nested_structure():
    from radiocore_tpu_torch.ops.nco_pll import PLLState
    from radiocore_tpu_torch.runtime.checkpoint import (state_from_numpy,
                                                        state_to_numpy)
    state_j, state_t = _nco_states()
    out = state_to_numpy(state_t)
    assert isinstance(out["pll"], PLLState)
    assert isinstance(out["pll"].phase, np.ndarray)
    np.testing.assert_array_equal(out["pll"].freq,
                                  np.asarray(state_j["pll"].freq))
    again = state_from_numpy(out, "cpu")
    assert torch.equal(again["pll"].phase, state_t["pll"].phase)
    # The copies are the port's own: writing to one leaves the source.
    again["deemph_l"].zero_()
    assert bool((state_t["deemph_l"] != 0).any())


@pytest.mark.parametrize("pll,first", [("analytic", "jax"),
                                       ("analytic", "port"),
                                       ("nco", "jax"), ("nco", "port")])
def test_stream_resumes_in_the_other_package(tmp_path, pll, first):
    """Chunk 1 in one package, its state saved, loaded by the other,
    chunk 2 there: the audio is what one package gives for both chunks."""
    from radiocore_tpu.models import wbfm as jw
    from radiocore_tpu.runtime import checkpoint as jc
    from radiocore_tpu_torch.models import wbfm as tw
    from radiocore_tpu_torch.runtime import checkpoint as tc
    n, m = 50_000, 10_000
    iq = make_fm_iq(make_stereo_multiplex(2 * n, n, 440.0, 1000.0),
                    0.25).astype(np.complex64).reshape(2, n)
    step_j = jax.jit(jw.make_wbfm_step(n, m, pll=pll))
    step_t = tw.make_wbfm_step(n, m, pll=pll)
    init_j = jw.wbfm_init_state(m, pll=pll)
    init_t = tw.wbfm_init_state(m, pll=pll, device="cpu")
    _, mid_j = step_j(jnp.asarray(iq[0]), init_j)
    want, _ = step_j(jnp.asarray(iq[1]), mid_j)
    path = str(tmp_path / "mid.npz")
    if first == "jax":
        jc.save_state(path, mid_j)
        got, _ = step_t(torch.from_numpy(iq[1]), tc.load_state(path, init_t))
        got = got.numpy()
    else:
        _, mid_t = step_t(torch.from_numpy(iq[0]), init_t)
        tc.save_state(path, mid_t)
        got, _ = step_j(jnp.asarray(iq[1]), jc.load_state(path, init_j))
        got = np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=4e-5)

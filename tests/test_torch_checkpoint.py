"""State crosses between the packages: a JAX ``save_state`` npz loads
with the port's ``load_state`` and round-trips through
``state_to_numpy``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp


def _jax_state(seed=0):
    rng = np.random.default_rng(seed)
    return {k: jnp.asarray(rng.standard_normal((4, 50)).astype(np.float32))
            for k in ("deemph_l", "deemph_r")}


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

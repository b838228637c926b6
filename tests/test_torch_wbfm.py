"""The port's fast WBFM step (models/wbfm.py) against the JAX one on FM
stereo IQ, batched over two stations and chained over two chunks, for
an envelope-tail size and a legacy-tail size."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import make_fm_iq, make_stereo_multiplex

torch.set_num_threads(2)


@pytest.mark.parametrize("n,m", [(262_144, 49_152), (65_536, 16_384)])
def test_fast_step_matches_jax(n, m):
    from radiocore_tpu.models import wbfm as jw
    from radiocore_tpu_torch.models import wbfm as tw
    iq = np.stack([make_fm_iq(make_stereo_multiplex(n, n, fl, fr), 0.25)
                   for fl, fr in ((440.0, 1000.0), (700.0, 300.0))])
    iq = iq.astype(np.complex64)
    step_j = jw.make_wbfm_step(n, m, mode="fast")
    step_t = tw.make_wbfm_step(n, m, mode="fast")
    assert (tw.make_wbfm_step(n, m, mode="fast_spec").needed_bins
            == jw.make_wbfm_step(n, m, mode="fast_spec").needed_bins)
    state_j = jw.wbfm_init_state(m, batch_shape=(2,))
    state_t = tw.wbfm_init_state(m, batch_shape=(2,), device="cpu")
    for _ in range(2):
        want, state_j = step_j(jnp.asarray(iq), state_j)
        got, state_t = step_t(torch.from_numpy(iq), state_t)
        assert tuple(got.shape) == (2, m, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=4e-5)
        for key in state_j:
            np.testing.assert_allclose(state_t[key].numpy(),
                                       np.asarray(state_j[key]), atol=4e-5)


def test_unknown_mode_raises_value_error():
    """An unknown ``mode`` is a ``ValueError``, as in the reference."""
    from radiocore_tpu.models.wbfm import make_wbfm_step as jax_step
    from radiocore_tpu_torch.models.wbfm import make_wbfm_step
    for make in (jax_step, make_wbfm_step):
        with pytest.raises(ValueError, match="mode"):
            make(65_536, 16_384, mode="faster")

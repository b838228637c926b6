"""K-FIR and the streaming FIR ops on the CPU: the plain K-FIR against
the JAX Pallas kernel (interpret mode), and the port's ``fir_causal`` /
``fir_stream`` / de-emphasis against the JAX ones."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

ATOL = 1e-5
SHAPE = (3, 49_152)


def _taps(t):
    if t == 51:
        from radiocore_tpu_torch.ops.design import deemphasis_taps
        return deemphasis_taps(49_152)
    from scipy import signal
    return signal.firwin(t, 0.45)


def _signal(seed, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    hist = rng.standard_normal(SHAPE[:-1] + (t - 1,)).astype(np.float32)
    return x, hist


@pytest.mark.parametrize("with_history", [True, False])
@pytest.mark.parametrize("t", [51, 129])
def test_plain_kernel_matches_pallas(t, with_history):
    from radiocore_tpu.kernels.fir_pallas import fir_causal_pallas
    from radiocore_tpu_torch.kernels.fir import fir_causal_rows
    taps = _taps(t)
    x, hist = _signal(t, t)
    h_j = jnp.asarray(hist) if with_history else None
    h_t = torch.from_numpy(hist) if with_history else None
    want = np.asarray(fir_causal_pallas(jnp.asarray(x), taps, history=h_j))
    got = fir_causal_rows(torch.from_numpy(x), taps, h_t).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("t", [51, 129])
def test_fir_stream_matches_jax(t):
    """Three chained chunks through both packages' fir_stream."""
    from radiocore_tpu.ops.fir import fir_stream as jax_stream
    from radiocore_tpu_torch.ops.fir import fir_stream
    taps = _taps(t)
    _, hist = _signal(7, t)
    h_j, h_t = jnp.asarray(hist), torch.from_numpy(hist)
    rng = np.random.default_rng(8)
    for _ in range(3):
        x = rng.standard_normal(SHAPE).astype(np.float32)
        want, h_j = jax_stream(jnp.asarray(x), taps, h_j)
        got, h_t = fir_stream(torch.from_numpy(x), taps, h_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))


def test_fir_causal_short_and_complex_match_jax():
    from radiocore_tpu.ops.fir import fir_causal as jax_fir
    from radiocore_tpu_torch.ops.fir import fir_causal
    taps = _taps(51)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4000))
         + 1j * rng.standard_normal((2, 4000))).astype(np.complex64)
    want = np.asarray(jax_fir(jnp.asarray(x), taps))
    got = fir_causal(torch.from_numpy(x), taps).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_deemphasis_matches_jax():
    from radiocore_tpu.ops import deemphasis as jd
    from radiocore_tpu_torch.ops import deemphasis as td
    taps_j, hist_j = jd.deemphasis_init(49_152, batch_shape=(3,))
    taps_t, hist_t = td.deemphasis_init(49_152, batch_shape=(3,),
                                        device="cpu")
    np.testing.assert_array_equal(taps_t, taps_j)
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
    x = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    want, _ = jd.deemphasis_apply(jnp.asarray(x), taps_j, hist_j)
    got, _ = td.deemphasis_apply(torch.from_numpy(x), taps_t, hist_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_kernel_route_needs_cuda():
    """A non-CPU, non-CUDA tensor raises instead of falling back."""
    from radiocore_tpu_torch.kernels.fir import fir_causal_rows
    with pytest.raises(ValueError):
        fir_causal_rows(torch.empty(SHAPE, device="meta"), _taps(51))

"""The port's FIR ops (ops/fir.py: ``zero_phase_fir``,
``fir_overlap_save``, ``fir_causal``'s ``impl``) against the JAX ones on
the cells of tests/test_fir.py, and the routing by dtype and size."""

import numpy as np
import pytest
import torch
from scipy import signal as sig

import jax.numpy as jnp

torch.set_num_threads(2)

RNG_SEED = 7
REL = 1e-5   # of the largest magnitude of the JAX result


def _pair():
    from radiocore_tpu.ops import fir as jf
    from radiocore_tpu_torch.ops import fir as tf
    return jf, tf


def _close(got: torch.Tensor, want, rel=REL) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_zero_phase_fir_matches_jax_and_filtfilt(lead):
    jf, tf = _pair()
    from radiocore_tpu_torch.ops import design
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal(lead + (2000,)).astype(np.float32)
    taps = design.bandpass_taps(41, 19e3 - 50, 19e3 + 50, 100_000)
    got = tf.zero_phase_fir(torch.from_numpy(x), taps)
    _close(got, jf.zero_phase_fir(jnp.asarray(x), taps))
    want = sig.filtfilt(taps, [1.0], x.astype(np.float64), axis=-1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_zero_phase_fir_batched_wide_taps_and_padlen():
    jf, tf = _pair()
    rng = np.random.default_rng(RNG_SEED + 1)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    taps = sig.firwin(61, [0.2, 0.5], pass_zero=False)
    _close(tf.zero_phase_fir(torch.from_numpy(x), taps),
           jf.zero_phase_fir(jnp.asarray(x), taps))
    _close(tf.zero_phase_fir(torch.from_numpy(x), taps, padlen=100),
           jf.zero_phase_fir(jnp.asarray(x), taps, padlen=100))
    with pytest.raises(ValueError, match="padlen"):
        tf.zero_phase_fir(torch.from_numpy(x[:, :150]), taps)


def test_zero_phase_fir_leaves_its_input():
    _, tf = _pair()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 500)).astype(np.float32))
    keep = x.clone()
    tf.zero_phase_fir(x, sig.firwin(21, 0.3))
    assert torch.equal(x, keep)


@pytest.mark.parametrize("n,block", [(10_000, 4096), (65_536, 4096),
                                     (12_345, 4096), (40_000, 1 << 15)])
def test_overlap_save_real_matches_jax(n, block):
    jf, tf = _pair()
    rng = np.random.default_rng(RNG_SEED + n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    taps = sig.firwin(63, 0.3)
    got = tf.fir_overlap_save(torch.from_numpy(x), taps, block=block)
    _close(got, jf.fir_overlap_save(jnp.asarray(x), taps, block=block))
    _close(got, tf.fir_causal(torch.from_numpy(x), taps, impl="plain"),
           rel=2e-4)


def test_overlap_save_complex_with_history_matches_jax():
    jf, tf = _pair()
    rng = np.random.default_rng(RNG_SEED)
    taps = sig.firwin(41, 0.2)
    x = (rng.standard_normal(20_000) + 1j * rng.standard_normal(20_000)
         ).astype(np.complex64)
    hist = (rng.standard_normal(40) + 1j * rng.standard_normal(40)
            ).astype(np.complex64)
    got = tf.fir_overlap_save(torch.from_numpy(x), taps,
                              history=torch.from_numpy(hist), block=2048)
    _close(got, jf.fir_overlap_save(jnp.asarray(x), taps,
                                    history=jnp.asarray(hist), block=2048))
    _close(got, jf.fir_causal(jnp.asarray(x), taps,
                              history=jnp.asarray(hist), impl="conv"),
           rel=2e-4)
    with pytest.raises(ValueError, match="block"):
        tf.fir_overlap_save(torch.from_numpy(x), taps, block=16)


@pytest.mark.parametrize("impl", ["auto", "kernel", "pallas", "plain",
                                  "conv", "fft"])
def test_fir_causal_every_impl_matches_jax(impl):
    """Every ``impl`` spelling of either package, with a history."""
    jf, tf = _pair()
    rng = np.random.default_rng(RNG_SEED)
    x = rng.standard_normal((2, 40_000)).astype(np.float32)
    hist = rng.standard_normal((2, 30)).astype(np.float32)
    taps = sig.firwin(31, 0.3)
    want = jf.fir_causal(jnp.asarray(x), taps, history=jnp.asarray(hist),
                         impl="conv")
    got = tf.fir_causal(torch.from_numpy(x), taps,
                        history=torch.from_numpy(hist), impl=impl)
    _close(got, want, rel=2e-4 if impl == "fft" else REL)


def test_fir_causal_unknown_impl_raises():
    _, tf = _pair()
    with pytest.raises(ValueError, match="impl"):
        tf.fir_causal(torch.zeros(100), np.ones(3), impl="mxu")


def test_more_than_max_taps_goes_to_overlap_save():
    """More taps than K-FIR takes: the route is overlap-save, chosen
    before any kernel, and the result is the direct form's."""
    _, tf = _pair()
    from radiocore_tpu_torch.kernels import fir as kfir
    rng = np.random.default_rng(RNG_SEED)
    taps = rng.standard_normal(kfir.MAX_TAPS + 5) / kfir.MAX_TAPS
    x = torch.from_numpy(rng.standard_normal((2, 20_000)).astype(np.float32))
    assert tf.fir_route(x, taps, "kernel") == "fft"
    assert tf.fir_route(x, taps[:kfir.MAX_TAPS], "kernel") == "kernel"
    got = tf.fir_causal(x, taps, impl="kernel")
    want = sig.lfilter(taps, 1.0, x.numpy().astype(np.float64), axis=-1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_float64_history_is_cast_for_the_kernel_slot():
    _, tf = _pair()
    rng = np.random.default_rng(RNG_SEED)
    x = torch.from_numpy(rng.standard_normal((2, 5000)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal((2, 30)))
    taps = sig.firwin(31, 0.3)
    assert hist.dtype == torch.float64
    got = tf.fir_causal(x, taps, history=hist, impl="kernel")
    assert got.dtype == torch.float32
    want = tf.fir_causal(x, taps, history=hist.float(), impl="plain")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


class _Cuda:
    """What ``fir_route`` and ``_use_kernel`` read of a tensor, for a
    tensor that would lie on a card."""
    is_cuda = True

    def __init__(self, dtype, n):
        self.dtype, self.shape = dtype, (4, n)


@pytest.mark.parametrize("dtype,n,taps,impl,slot", [
    (torch.float32, 65_536, 51, "auto", "kernel"),
    (torch.float32, 1000, 51, "auto", "plain"),        # short
    (torch.float64, 65_536, 51, "auto", "plain"),
    (torch.complex64, 65_536, 51, "auto", "plain"),
    (torch.float32, 65_536, 5000, "auto", "fft"),
    (torch.float32, 1000, 51, "kernel", "kernel"),
    (torch.float64, 65_536, 51, "kernel", "plain"),
    (torch.complex64, 65_536, 51, "pallas", "plain"),
    (torch.float32, 65_536, 4097, "kernel", "fft"),
    (torch.float32, 65_536, 4096, "kernel", "kernel"),
    (torch.float32, 65_536, 5000, "conv", "plain"),
    (torch.float32, 65_536, 51, "fft", "fft"),
])
def test_fir_route_on_a_card_by_dtype_and_size(dtype, n, taps, impl, slot):
    _, tf = _pair()
    assert tf.fir_route(_Cuda(dtype, n), np.ones(taps), impl) == slot


def test_fir_route_auto_needs_host_taps():
    _, tf = _pair()
    assert tf.fir_route(_Cuda(torch.float32, 65_536), [1.0] * 51) == "plain"


@pytest.mark.parametrize("n,dtype,is_cuda,slot", [
    (1 << 24, torch.complex64, True, "rows"),
    (1 << 24, torch.complex128, True, "torch"),
    (1 << 24, torch.complex64, False, "torch"),
    (1 << 23, torch.complex64, True, "torch"),
    (96 << 18, torch.complex64, True, "mixed"),
    (96 << 18, torch.complex128, True, "torch"),
    (250_000, torch.complex64, True, "torch"),
])
def test_fft_route_by_dtype_and_size(n, dtype, is_cuda, slot):
    from radiocore_tpu_torch.ops import fft as offt
    assert offt.route_name(n, dtype, is_cuda) == slot


def test_fft_keeps_double_precision():
    from radiocore_tpu_torch.ops import fft as offt
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1000))
    got = offt.fft(x)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), np.fft.fft(x.numpy()),
                               atol=1e-10)

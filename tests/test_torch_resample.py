"""The port's FFT resampler (ops/resample.py) against the JAX one on the
cells of tests/test_resample.py: the same seeded NumPy input through
both, within 1e-5 of the output's largest magnitude."""

import numpy as np
import pytest
import torch
from scipy import signal as sig

import jax.numpy as jnp

torch.set_num_threads(2)

REL = 1e-5   # of the largest magnitude of the JAX result


def _pair():
    from radiocore_tpu.ops import resample as jr
    from radiocore_tpu_torch.ops import resample as tr
    return jr, tr


def _signal(n, complex_, seed=42, lead=()):
    rng = np.random.default_rng(seed + n)
    x = rng.standard_normal(lead + (n,))
    if complex_:
        return (x + 1j * rng.standard_normal(lead + (n,))).astype(
            np.complex64)
    return x.astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * np.abs(want).max())


SIZES = [(1000, 200), (1000, 250), (1000, 1000), (500, 1500), (999, 333),
         (1000, 321), (320, 1001)]


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("windowed", [False, True], ids=["plain", "window"])
@pytest.mark.parametrize("n,num", SIZES)
def test_resample_fft_matches_jax(n, num, windowed, complex_):
    jr, tr = _pair()
    x = _signal(n, complex_)
    win = np.fft.fftshift(sig.get_window("hamm", n)) if windowed else None
    _close(tr.resample_fft(torch.from_numpy(x), num, window=win),
           jr.resample_fft(jnp.asarray(x), num, window=win))


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_resample_fft_batched(complex_):
    jr, tr = _pair()
    from radiocore_tpu_torch.ops import design
    x = _signal(600, complex_, lead=(2, 3))
    win = design.resample_window("hamm", 600)
    got = tr.resample_fft(torch.from_numpy(x), 120, window=win)
    _close(got, jr.resample_fft(jnp.asarray(x), 120, window=win))
    one = tr.resample_fft(torch.from_numpy(x[1, 2]), 120, window=win)
    np.testing.assert_allclose(got[1, 2].numpy(), one.numpy(), atol=1e-6)


@pytest.mark.parametrize("n,num", [(800, 160), (800, 161), (801, 160),
                                   (800, 800), (160, 800), (161, 800),
                                   (160, 801)])
def test_resample_spectrum_matches_jax_and_keeps_its_input(n, num):
    jr, tr = _pair()
    x = _signal(n, True, lead=(2,))
    X = (np.fft.fft(x) * np.fft.fftshift(sig.get_window("hann", n))).astype(
        np.complex64)
    Xt = torch.from_numpy(X.copy())
    got = tr.resample_spectrum(Xt, num)
    _close(got, jr.resample_spectrum(jnp.asarray(X), num))
    # One band spectrum serves many channels: it must come back untouched.
    np.testing.assert_array_equal(Xt.numpy(), X)


def test_resample_spectrum_matches_scipy_freq_domain():
    _, tr = _pair()
    x = _signal(800, True).astype(np.complex128)
    X = np.fft.fft(x) * np.fft.fftshift(sig.get_window("hann", 800))
    want = sig.resample(X, 160, domain="freq")
    got = tr.resample_spectrum(torch.from_numpy(X.astype(np.complex64)), 160)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-4 * np.abs(want).max())


def test_real_resample_weights_are_the_real_path():
    """The weights a model precomputes give ``resample_fft``'s result."""
    _, tr = _pair()
    x = torch.from_numpy(_signal(1000, False, lead=(3,)))
    win = np.fft.fftshift(sig.get_window("hamm", 1000))
    w = torch.from_numpy(tr.real_resample_weights(1000, 200, win)).float()
    assert torch.equal(tr.resample_real(x, 200, w),
                       tr.resample_fft(x, 200, window=win))

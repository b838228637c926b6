"""The port's analytic signal and pilot harmonics (ops/analytic.py)
against the JAX ones: seeded NumPy input through both, within 1e-5 of
the result's largest magnitude."""

import numpy as np
import pytest
import torch
from scipy import signal as sig

import jax.numpy as jnp

torch.set_num_threads(2)

REL = 1e-5


def _pair():
    from radiocore_tpu.ops import analytic as ja
    from radiocore_tpu_torch.ops import analytic as ta
    return ja, ta


@pytest.mark.parametrize("shape", [(1000,), (999,), (3, 4096), (2, 2, 501)])
def test_analytic_signal_matches_jax_and_scipy(shape):
    ja, ta = _pair()
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    got = ta.analytic_signal(torch.from_numpy(x))
    want = np.asarray(ja.analytic_signal(jnp.asarray(x)))
    assert got.dtype == torch.complex64 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), sig.hilbert(x.astype(np.float64)),
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("mult,part", [(1, "real"), (1, "imag"),
                                       (2, "real"), (2, "imag"),
                                       (3, "imag")])
def test_pll_harmonic_of_a_pilot_matches_jax(mult, part):
    ja, ta = _pair()
    fs = 100_000
    t = np.arange(fs) / fs
    pilot = np.stack([np.sin(2 * np.pi * 19e3 * t + p) for p in (0.5, 2.0)])
    pilot = pilot.astype(np.float32)
    got = ta.pll_harmonic(ta.analytic_signal(torch.from_numpy(pilot)),
                          mult, part)
    want = np.asarray(ja.pll_harmonic(ja.analytic_signal(jnp.asarray(pilot)),
                                      mult, part))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # Unit amplitude: sin(θ) gives −cos(mθ) (real) or sin(mθ)·… on the
    # interior; only the magnitude is pinned here.
    assert float(got.abs().max()) <= 1.0 + 1e-6


def test_analytic_signal_of_a_dead_pilot_gives_nan_harmonic():
    """0/0 on a dead channel, in both packages (the exact mode's NaN)."""
    ja, ta = _pair()
    z = np.zeros(256, np.float32)
    got = ta.pll_harmonic(ta.analytic_signal(torch.from_numpy(z)), 2, "imag")
    want = np.asarray(ja.pll_harmonic(ja.analytic_signal(jnp.asarray(z)), 2,
                                      "imag"))
    assert np.isnan(want).all() and bool(torch.isnan(got).all())

"""The port's quadrature demod (ops/demod.py) against the JAX one, and
its convention on a dead channel: zeros of any sign demodulate to 0."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from oracles import make_fm_iq, make_stereo_multiplex

torch.set_num_threads(2)


@pytest.mark.parametrize("gain", [None, 0.5])
def test_quadrature_demod_matches_jax(gain):
    from radiocore_tpu.ops.demod import quadrature_demod as jax_demod
    from radiocore_tpu_torch.ops.demod import quadrature_demod
    n = 50_000
    iq = np.stack([make_fm_iq(make_stereo_multiplex(n, n, fl, fr), 0.25)
                   for fl, fr in ((440.0, 1000.0), (700.0, 300.0))])
    iq = iq.astype(np.complex64).reshape(2, 1, n)
    got = quadrature_demod(torch.from_numpy(iq), gain)
    want = np.asarray(jax_demod(jnp.asarray(iq), gain))
    assert tuple(got.shape) == (2, 1, n) and got.dtype == torch.float32
    assert bool((got[..., 0] == 0).all())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_zeros_of_any_sign_demodulate_to_zero():
    """Every combination of signed zeros in two neighbouring samples:
    ``angle`` of their plain product is ±π for some (a real part of −0);
    the demod gives 0 for all, as the JAX package gives for a dead
    channel."""
    from radiocore_tpu.ops.demod import quadrature_demod as jax_demod
    from radiocore_tpu_torch.ops.demod import quadrature_demod
    signs = list(itertools.product([0.0, -0.0], repeat=4))
    pairs = np.array([[complex(a, b), complex(c, d)] for a, b, c, d in signs],
                     np.complex64)
    plain = torch.angle(torch.from_numpy(pairs[:, 1])
                        * torch.conj(torch.from_numpy(pairs[:, 0])))
    assert bool((plain.abs() > 3).any())      # the hazard is real
    got = quadrature_demod(torch.from_numpy(pairs))
    assert bool((got == 0).all())
    dead = np.asarray(jax_demod(jnp.zeros((1, 64), jnp.complex64)))
    assert (dead == 0).all()


def test_live_samples_keep_their_bits():
    """The repair adds an exact zero: live samples are what the plain
    product's angle gives, bit for bit."""
    from radiocore_tpu_torch.ops.demod import quadrature_demod
    rng = np.random.default_rng(0)
    iq = torch.from_numpy((rng.standard_normal((3, 4096)) + 1j
                           * rng.standard_normal((3, 4096))).astype(
                               np.complex64))
    plain = torch.angle(iq[..., 1:] * torch.conj(iq[..., :-1])) * (1.0 / np.pi)
    assert torch.equal(quadrature_demod(iq)[..., 1:], plain)

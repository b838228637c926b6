"""The port's polyphase filterbank channelizer (``ops/pfb``) against the
JAX package on the CPU: the cells of ``test_pfb.py`` (tone routing,
negative channels, streaming, batches, real input, size checks), each on
the same seeded input through both packages. Tolerance 2e-6 abs on the
channels (``test_halo_streaming.py``'s PFB bound); the taps are the
same SciPy design in both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

FS = 64_000
M = 16          # 16 channels of 4 kHz
P = 8
ATOL = 2e-6


def _tone(f, n=FS, fs=FS, amp=1.0):
    return (amp * np.exp(2j * np.pi * f * np.arange(n) / fs)
            ).astype(np.complex64)


def _both(x, taps, m=M, history=None):
    """``pfb_channelize`` of both packages on ``x``; numpy results."""
    from radiocore_tpu.ops.pfb import pfb_channelize as jax_pfb
    from radiocore_tpu_torch.ops.pfb import pfb_channelize
    hj = None if history is None else jnp.asarray(history)
    ht = None if history is None else torch.from_numpy(history)
    want, want_h = jax_pfb(jnp.asarray(x), taps, m, history=hj)
    got, got_h = pfb_channelize(torch.from_numpy(x), taps, m, history=ht)
    return (got.numpy(), got_h.numpy()), (np.asarray(want),
                                          np.asarray(want_h))


def test_taps_equal_jax():
    from radiocore_tpu.ops.pfb import pfb_taps as jax_taps
    from radiocore_tpu_torch.ops.pfb import pfb_taps
    for m, p, scale in ((16, 8, 1.0), (64, 8, 1.0), (16, 4, 0.8)):
        np.testing.assert_array_equal(pfb_taps(m, p, scale),
                                      jax_taps(m, p, scale))
    assert pfb_taps(M, P).sum() == pytest.approx(1.0)


def test_tone_lands_in_its_channel():
    from radiocore_tpu_torch.ops.pfb import pfb_taps
    taps = pfb_taps(M, P)
    k0, delta = 3, 200.0                      # 3·4 kHz + 200 Hz
    (ch, _), (want, _) = _both(_tone(k0 * FS / M + delta), taps)
    assert ch.shape == (FS // M, M)
    np.testing.assert_allclose(ch, want, atol=ATOL)
    power = np.mean(np.abs(ch) ** 2, axis=0)
    assert np.argmax(power) == k0
    assert abs(power[k0] - 1.0) < 0.1
    far = np.delete(power, [k0 - 1, k0, k0 + 1])
    assert 10 * np.log10(power[k0] / far.max()) > 20
    # Exactly on centre: the prototype's stopband rejection in full.
    (centre, _), (want_c, _) = _both(_tone(k0 * FS / M), taps)
    np.testing.assert_allclose(centre, want_c, atol=ATOL)
    p_c = np.mean(np.abs(centre) ** 2, axis=0)
    far_c = np.delete(p_c, [k0 - 1, k0, k0 + 1])
    assert 10 * np.log10(p_c[k0] / far_c.max()) > 40
    # The residual offset lands at baseband of the decimated channel.
    spec = np.abs(np.fft.fft(ch[P:, k0]))
    expect = round(delta * (len(ch) - P) / (FS / M))
    assert abs(np.argmax(spec) - expect) <= 1


def test_negative_channel_wraps():
    from radiocore_tpu_torch.ops.pfb import pfb_taps
    (ch, _), (want, _) = _both(_tone(-FS / M), pfb_taps(M, P))
    np.testing.assert_allclose(ch, want, atol=ATOL)
    assert np.argmax(np.mean(np.abs(ch) ** 2, axis=0)) == M - 1


def test_streaming_chunks_match_one_shot_and_jax():
    from radiocore_tpu_torch.ops.pfb import pfb_init, pfb_taps
    taps = pfb_taps(M, P)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(3 * FS) + 1j * rng.standard_normal(3 * FS)
         ).astype(np.complex64)
    (whole, _), _ = _both(x, taps)
    hist = pfb_init(M, P, device="cpu").numpy()
    parts = []
    for i in range(3):
        (ch, hist), (want, want_h) = _both(x[i * FS:(i + 1) * FS], taps,
                                           history=hist)
        np.testing.assert_allclose(ch, want, atol=ATOL)
        np.testing.assert_array_equal(hist, want_h)
        parts.append(ch)
    np.testing.assert_allclose(np.concatenate(parts), whole, atol=1e-5)
    np.testing.assert_array_equal(hist, x[-(P - 1) * M:])


def test_batched():
    from radiocore_tpu_torch.ops.pfb import pfb_channelize, pfb_taps
    taps = pfb_taps(M, P)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, FS)) + 1j * rng.standard_normal((2, FS))
         ).astype(np.complex64)
    (ch, hist), (want, _) = _both(x, taps)
    assert ch.shape == (2, FS // M, M)
    assert hist.shape == (2, (P - 1) * M)
    np.testing.assert_allclose(ch, want, atol=ATOL)
    one, _ = pfb_channelize(torch.from_numpy(x[1]), taps, M)
    np.testing.assert_allclose(ch[1], one.numpy(), atol=1e-6)


def test_real_input():
    from radiocore_tpu_torch.ops.pfb import pfb_taps
    x = np.cos(2 * np.pi * 2 * FS / M * np.arange(FS) / FS).astype(np.float32)
    (ch, _), (want, _) = _both(x, pfb_taps(M, P))
    assert ch.dtype == np.complex64
    np.testing.assert_allclose(ch, want, atol=ATOL)
    power = np.mean(np.abs(ch) ** 2, axis=0)
    assert set(np.argsort(power)[-2:]) == {2, M - 2}


def test_one_tap_a_branch_keeps_no_history():
    from radiocore_tpu_torch.ops.pfb import pfb_taps
    x = np.random.default_rng(2).standard_normal(4096).astype(np.complex64)
    (ch, hist), (want, want_h) = _both(x, pfb_taps(M, 1))
    assert hist.shape == want_h.shape == (0,)
    np.testing.assert_allclose(ch, want, atol=ATOL)


def test_validates_sizes():
    from radiocore_tpu_torch.ops.pfb import pfb_channelize, pfb_taps
    taps = pfb_taps(M, P)
    with pytest.raises(ValueError):
        pfb_channelize(torch.zeros(FS + 1, dtype=torch.complex64), taps, M)
    with pytest.raises(ValueError):
        pfb_channelize(torch.zeros(FS, dtype=torch.complex64), taps[:-1], M)


def test_init_is_on_the_named_device():
    from radiocore_tpu_torch.ops.pfb import pfb_init
    h = pfb_init(M, P, (3,), device="cpu")
    assert h.shape == (3, (P - 1) * M) and h.dtype == torch.complex64
    assert not h.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            pfb_init(M, P)

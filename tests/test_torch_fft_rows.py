"""K-FFT (radiocore_tpu_torch/kernels/fft_rows.py) on the CPU: its plain
versions against the JAX Pallas kernels (interpret mode), and its pass
plan — the strides, twiddles and buffer roles the CUDA kernel is given —
emulated in numpy against np.fft."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)


def _c64(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def emulate_passes(passes, x, sign, out_size, modes=None, load_fn=None,
                   bufs=None):
    """numpy model of csrc/fft_common.cuh's pass kernel: each sub-FFT
    (b0, b1, s) reads element j at b0*ib0 + b1*ib1 + s*is_ + j*ij, takes
    an L-point DFT, applies the twiddle or the (-1)^off flip, and writes
    element k at b0*ob0 + b1*ob1 + s*os + k*ok (only where s*os + k*ok <
    keep, for a pass with ``keep``). ``modes[i]`` is the (load, store)
    mode of pass i; ``load_fn(src, off)`` the extract load. ``bufs``
    (name -> array, names may alias one array) replaces the default
    x / y / s buffers; ``out_size`` is the element count a pass writes.
    """
    if bufs is None:
        bufs = {"x": np.asarray(x, np.complex128).ravel(),
                "y": np.zeros(out_size, np.complex128),
                "s": np.zeros(out_size, np.complex128)}
    for i, p in enumerate(passes):
        load, store = modes[i] if modes else (0, 0)
        assert p.src != p.dst
        b0, b1, s, j = np.ix_(np.arange(p.B0), np.arange(p.B1),
                              np.arange(p.S), np.arange(p.L))
        off = b0 * p.ib0 + b1 * p.ib1 + s * p.is_ + j * p.ij
        src = bufs[p.src]
        v = src[off] if load == 0 else load_fn(src, off)
        if sign < 0:
            v = np.fft.fft(v, axis=-1)
        else:
            v = np.fft.ifft(v, axis=-1) * p.L
        k = j
        if store == 0 and p.tw_n:
            v = v * np.exp(sign * 2j * np.pi * ((s * k) % p.tw_n) / p.tw_n)
        rel = np.broadcast_to(s * p.os + k * p.ok, v.shape)
        out = np.broadcast_to(b0 * p.ob0 + b1 * p.ob1, v.shape) + rel
        if store == 1:
            v = np.where(out & 1, -v, v)
        if p.keep:
            out, v = out[rel < p.keep], v[rel < p.keep]
        # Each pass writes every element of its output exactly once.
        assert np.unique(out).size == out.size == out_size
        assert out.max() < out_size
        bufs[p.dst][out] = v
    return bufs.get("y")


def _check_plan_invariants(passes, fr):
    for p in passes:
        assert 2 <= p.L <= fr.SUB_MAX
        assert p.P & (p.P - 1) == 0 and p.P * p.L <= fr.BLOCK_POINTS
        assert p.tw_n == 0 or p.tw_n & (p.tw_n - 1) == 0


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("n,batch", [(256, 3), (4096, 2), (1 << 13, 2),
                                     (1 << 18, 1), (1 << 20, 1)])
def test_pass_plan_emulated(n, batch, sign):
    from radiocore_tpu_torch.kernels import fft_rows as fr
    passes = fr.plan(n, batch)
    _check_plan_invariants(passes, fr)
    x = _c64((batch, n), seed=n + batch).astype(np.complex128)
    got = emulate_passes(passes, x, sign, batch * n).reshape(batch, n)
    want = (np.fft.fft(x, axis=-1) if sign < 0
            else np.fft.ifft(x, axis=-1) * n)
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("n", [1 << 9, 1 << 10, 1 << 12])
def test_three_pass_plan_emulated(n, monkeypatch):
    """Rows longer than SUB_MAX**2 take three passes; shrink SUB_MAX so a
    small row exercises that plan."""
    from radiocore_tpu_torch.kernels import fft_rows as fr
    monkeypatch.setattr(fr, "SUB_MAX", 16)
    monkeypatch.setattr(fr, "BLOCK_POINTS", 64)
    fr.plan.cache_clear()
    try:
        passes = fr.plan(n, 2)
        assert len(passes) == 3
        _check_plan_invariants(passes, fr)
        x = _c64((2, n), seed=n).astype(np.complex128)
        got = emulate_passes(passes, x, -1.0, 2 * n).reshape(2, n)
        assert _rel(got, np.fft.fft(x, axis=-1)) < 1e-12
    finally:
        fr.plan.cache_clear()


def test_main_path_plans():
    from radiocore_tpu_torch.kernels.fft_rows import plan
    assert [p.L for p in plan(1 << 18, 64)] == [512, 512]
    assert [p.L for p in plan(1 << 17, 64)] == [512, 256]
    band = plan(1 << 24, 1)
    assert [p.L for p in band] == [4096, 4096]
    assert band[0].tw_n == 1 << 24 and band[1].tw_n == 0


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("length,lead", [(256, (3,)), (1024, (2, 3)),
                                         (4096, (1,))])
def test_plain_matches_pallas_planar(length, lead, sign):
    from radiocore_tpu.kernels.fft_pallas import fft_pow2_pallas_planar
    from radiocore_tpu_torch.kernels.fft_rows import fft_pow2_planar
    x = _c64(lead + (length,), seed=length)
    wr, wi = fft_pow2_pallas_planar(jnp.asarray(x.real), jnp.asarray(x.imag),
                                    sign)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    gr, gi = fft_pow2_planar(torch.from_numpy(x.real.copy()),
                             torch.from_numpy(x.imag.copy()), sign)
    got = gr.numpy() + 1j * gi.numpy()
    assert _rel(got, want.astype(np.complex128)) < 1e-5


def test_plain_fft_and_ifft_match_pallas():
    from radiocore_tpu.kernels.fft_pallas import (fft_pow2_pallas,
                                                  ifft_pow2_pallas)
    from radiocore_tpu_torch.kernels.fft_rows import fft_pow2, ifft_pow2
    x = _c64((2, 2048), seed=3)
    want = np.asarray(fft_pow2_pallas(jnp.asarray(x)))
    got = fft_pow2(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < 1e-5
    want = np.asarray(ifft_pow2_pallas(jnp.asarray(x)))
    got = ifft_pow2(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_large_plain_matches_pallas(sign):
    from radiocore_tpu.kernels.fft_pallas import fft_large_pow2_pallas
    from radiocore_tpu_torch.kernels.fft_rows import fft_large_pow2
    n = 1 << 20
    x = _c64((n,), seed=11)
    want = np.asarray(fft_large_pow2_pallas(jnp.asarray(x), sign=sign))
    got = fft_large_pow2(torch.from_numpy(x), sign).numpy()
    assert _rel(got, want) < 1e-5


def test_rfft_plain_matches_pallas():
    from radiocore_tpu.kernels.fft_pallas import rfft_pow2_pallas
    from radiocore_tpu_torch.kernels.fft_rows import rfft_pow2
    x = np.random.default_rng(21).standard_normal((3, 8192)).astype(
        np.float32)
    want = np.asarray(rfft_pow2_pallas(jnp.asarray(x)))
    got = rfft_pow2(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 4097)
    assert _rel(got, want) < 1e-5


def test_irfft_plain_matches_pallas():
    from radiocore_tpu.kernels.fft_pallas import irfft_pow2_pallas
    from radiocore_tpu_torch.kernels.fft_rows import irfft_pow2
    spec = _c64((2, 1025), seed=23)      # DC/Nyquist imag left nonzero
    want = np.asarray(irfft_pow2_pallas(jnp.asarray(spec), 2048))
    got = irfft_pow2(torch.from_numpy(spec), 2048).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)


def test_rejects_bad_sizes():
    from radiocore_tpu_torch.kernels.fft_rows import fft_pow2, rfft_pow2
    with pytest.raises(ValueError):
        fft_pow2(torch.zeros(3000, dtype=torch.complex64))
    with pytest.raises(ValueError):
        fft_pow2(torch.zeros(1 << 20, dtype=torch.complex64))
    with pytest.raises(ValueError):
        rfft_pow2(torch.zeros(256, dtype=torch.float32))


def test_no_kernel_off_cuda_and_cpu():
    """A tensor on neither the CPU nor a CUDA device raises instead of
    falling back to the plain version; the CPU route launches nothing."""
    from radiocore_tpu_torch.kernels import fft_rows
    with pytest.raises(ValueError):
        fft_rows.fft_pow2(torch.empty(1024, dtype=torch.complex64,
                                      device="meta"))
    before = fft_rows.launches.count
    fft_rows.fft_pow2(torch.ones(1024, dtype=torch.complex64))
    assert fft_rows.launches.count == before


@pytest.mark.parametrize("n", [4096, 250_000])
def test_ops_fft_matches_jax(n):
    from radiocore_tpu.ops import fft as jfft
    from radiocore_tpu_torch.ops import fft as tfft
    x = _c64((2, n), seed=n)
    xr = x.real.copy()
    assert _rel(tfft.fft(torch.from_numpy(x)).numpy(),
                np.asarray(jfft.fft(jnp.asarray(x)))) < 1e-5
    assert _rel(tfft.ifft(torch.from_numpy(x)).numpy(),
                np.asarray(jfft.ifft(jnp.asarray(x)))) < 1e-5
    spec = tfft.rfft(torch.from_numpy(xr))
    assert _rel(spec.numpy(), np.asarray(jfft.rfft(jnp.asarray(xr)))) < 1e-5
    np.testing.assert_allclose(tfft.irfft(spec, n).numpy(), xr, atol=1e-5)


def test_rfft_untangle_matches_numpy():
    """The elementwise half of rfft_pow2's CUDA route, fed the half-length
    FFT of the even/odd-packed row."""
    from radiocore_tpu_torch.kernels.fft_rows import rfft_untangle
    x = np.random.default_rng(31).standard_normal((3, 4096)).astype(
        np.float32)
    z = torch.fft.fft(torch.view_as_complex(torch.from_numpy(x).view(
        3, 2048, 2)))
    got = rfft_untangle(z, 4096).numpy()
    assert _rel(got, np.fft.rfft(x.astype(np.float64), axis=-1)) < 1e-5


def test_irfft_tangle_matches_numpy():
    """The elementwise half of irfft_pow2's CUDA route, followed by the
    unnormalized backward FFT the kernel computes there."""
    from radiocore_tpu_torch.kernels.fft_rows import irfft_tangle
    spec = _c64((2, 1025), seed=32)      # DC/Nyquist imag left nonzero
    z = irfft_tangle(torch.from_numpy(spec), 2048)
    got = torch.view_as_real(torch.fft.ifft(z, norm="forward")).reshape(
        2, 2048) / 1024
    want = np.fft.irfft(spec.astype(np.complex128), 2048, axis=-1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)

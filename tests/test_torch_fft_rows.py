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


def stage_bits(lg):
    """csrc/fft_common.cuh stage_bits: ceil(lg/4) stages, larger first."""
    nst = (lg + 3) // 4
    return [lg // nst + (1 if st < lg % nst else 0) for st in range(nst)]


def dft_registers(u, sign):
    """numpy model of fft_common.cuh dft<R> on the last axis: radix-2
    decimation in frequency with the W_16 constants of rot16, then the
    bit-reversed renaming."""
    u = np.array(u, np.complex128)
    R = u.shape[-1]
    h = R // 2
    while h >= 1:
        for blk in range(0, R, 2 * h):
            for i in range(h):
                a, b = u[..., blk + i].copy(), u[..., blk + i + h].copy()
                u[..., blk + i] = a + b
                e = i * (8 // h)
                u[..., blk + i + h] = (a - b) * np.exp(sign * 2j * np.pi * e
                                                       / 16)
        h //= 2
    bits = R.bit_length() - 1
    rev = [int(format(k, f"0{bits}b")[::-1], 2) if bits else 0
           for k in range(R)]
    return u[..., rev]


def stockham(v, sign):
    """numpy model of fft_common.cuh fft_row on the last axis (L = 2^lg,
    16 <= L <= 4096): per stage of radix R and span Ns, butterfly b reads
    positions b + q*L/R, twiddles them by W_{Ns*R}^(q*(b mod Ns)) (the
    stage table's entry q*Ns + b mod Ns), takes dft<R> and writes output
    q at (b - b mod Ns)*R + b mod Ns + q*Ns."""
    v = np.asarray(v, np.complex128)
    L = v.shape[-1]
    Ns = 1
    for bits in stage_bits(L.bit_length() - 1):
        R = 1 << bits
        nb = L // R
        b = np.arange(nb)[:, None]
        q = np.arange(R)[None, :]
        bm = b & (Ns - 1)
        u = v[..., b + q * nb] * np.exp(sign * 2j * np.pi * q * bm / (Ns * R))
        out = np.empty_like(v)
        out[..., (b - bm) * R + bm + q * Ns] = dft_registers(u, sign)
        v = out
        Ns *= R
    return v


def sub_fft(v, sign):
    """The L-point DFT of a pass: the kernel's Stockham chain where the
    kernel takes L (16..4096), else np.fft (plans shrunk by a test)."""
    L = v.shape[-1]
    if 16 <= L <= 4096:
        return stockham(v, sign)
    return np.fft.fft(v, axis=-1) if sign < 0 else np.fft.ifft(v, axis=-1) * L


def emulate_passes(passes, x, sign, out_size, modes=None, load_fn=None,
                   bufs=None):
    """numpy model of csrc/fft_common.cuh's pass kernel: each sub-FFT
    (b0, b1, s) reads element j at b0*ib0 + b1*ib1 + s*is_ + j*ij, takes
    an L-point DFT (the kernel's Stockham stages, :func:`stockham`),
    applies the twiddle or the (-1)^off flip, and writes
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
        v = sub_fft(src[off] if load == 0 else load_fn(src, off), sign)
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
        assert p.P & (p.P - 1) == 0
        assert p.P * p.L <= max(fr.BLOCK_POINTS, fr.MIN_GROUP * p.L)
        assert p.P * p.L <= fr.KERNEL_BLOCK_POINTS
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
    rows = plan(1 << 18, 64)
    assert [p.L for p in rows] == [512, 512]
    assert [p.P for p in rows] == [8, 8]       # 256-thread blocks at 512
    assert [p.L for p in plan(1 << 17, 64)] == [512, 256]
    band = plan(1 << 24, 1)
    assert [p.L for p in band] == [4096, 4096]
    assert [p.P for p in band] == [4, 4]      # MIN_GROUP: 32-byte runs
    assert band[0].tw_n == 1 << 24 and band[1].tw_n == 0
    # The kernel's shortest sub-FFT is one thread's 16 points, and a
    # block is P*L/16 threads.
    for p in rows + band:
        assert 16 <= p.L and p.P * p.L // 16 <= 1024


@pytest.mark.parametrize("n,batch", [(1 << 18, 64), (1 << 17, 64),
                                     (1 << 19, 3), (1 << 24, 1), (512, 5)])
def test_block_threads_within_kernel_bounds(n, batch):
    """A block is P·L/16 threads: at most 256 for 512-point sub-FFTs (the
    launch bounds of the kernel built for that length, three blocks per
    SM) and 1024 otherwise."""
    from radiocore_tpu_torch.kernels import fft_rows as fr
    for p in fr.plan(n, batch):
        threads = p.P * p.L // fr.POINTS_PER_THREAD
        assert threads <= (256 if p.L == fr.FAST_SUB else 1024)
        assert p.P >= min(fr.MIN_GROUP, 1 << max(p.S - 1, 0).bit_length())


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("L", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_stockham_stages_match_numpy(L, sign):
    """The kernel's in-block FFT (stage radices, Stockham positions, table
    twiddles, in-register DFTs) against np.fft for every L it takes."""
    assert sum(stage_bits(L.bit_length() - 1)) == L.bit_length() - 1
    assert all(2 <= b <= 4 for b in stage_bits(L.bit_length() - 1))
    x = _c64((3, L), seed=L).astype(np.complex128)
    want = (np.fft.fft(x, axis=-1) if sign < 0
            else np.fft.ifft(x, axis=-1) * L)
    assert _rel(stockham(x, sign), want) < 1e-12


@pytest.mark.parametrize("R", [2, 4, 8, 16])
def test_register_dft_matches_numpy(R):
    x = _c64((4, R), seed=R).astype(np.complex128)
    assert _rel(dft_registers(x, -1.0), np.fft.fft(x, axis=-1)) < 1e-13
    assert _rel(dft_registers(x, 1.0), np.fft.ifft(x, axis=-1) * R) < 1e-13


@pytest.mark.parametrize("n,bits", [(1 << 24, 12), (1 << 24, 8),
                                    (96 << 18, 12), (96 << 18, 16)])
def test_two_level_twiddle_table(n, bits):
    """hi[r >> bits]·lo[r & mask], multiplied in float32 as the kernels
    do, is exp(±2πi·r/n) within 2 ulp of float32 (2·2^-23), for r near 0,
    near n and at random; n = 2^24 (the main band) and n = 96·2^18
    (K-MIXED's band, whose outer twiddle reads this table)."""
    from radiocore_tpu_torch.kernels.fft_rows import two_level_table
    rng = np.random.default_rng(bits)
    r = np.concatenate([np.arange(4096), n - 1 - np.arange(4096),
                        rng.integers(0, n, 100_000)])
    bound = 2 * np.finfo(np.float32).eps
    for sign in (-1.0, 1.0):
        hi, lo = two_level_table(n, sign, bits)
        assert hi.dtype == lo.dtype == np.complex64
        assert len(lo) == 1 << bits and len(hi) == -(-n // (1 << bits))
        h, l = hi[r >> bits], lo[r & ((1 << bits) - 1)]
        hx, hy, lx, ly = h.real, h.imag, l.real, l.imag
        got = ((hx * lx - hy * ly).astype(np.float64)
               + 1j * (hx * ly + hy * lx))
        want = np.exp(sign * 2j * np.pi * (r / n))
        assert np.abs(got - want).max() <= bound


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


def untangle_model(z):
    """numpy model of csrc/fft_rows.cu rfft_untangle_kernel: thread k <=
    h/2 writes X[k] and X[h-k] from Z[k] and Z[h-k] (Z[h] = Z[0]) with
    w = exp(-2πi·k/n) from sin/cos of πk/h and w[h-k] = -conj(w[k])."""
    rows, h = z.shape
    x = np.zeros((rows, h + 1), np.complex128)
    k = np.arange(h // 2 + 1)
    zk, zm = z[:, k], z[:, np.where(k == 0, 0, h - k)]
    sn, cs = np.sin(np.pi * k / h), np.cos(np.pi * k / h)
    a, b = 0.5 * (1 - sn) - 0.5j * cs, 0.5 * (1 + sn) + 0.5j * cs
    x[:, k] = a * zk + b * np.conj(zm)
    a, b = 0.5 * (1 - sn) + 0.5j * cs, 0.5 * (1 + sn) - 0.5j * cs
    x[:, h - k] = a * zm + b * np.conj(zk)
    return x


def test_rfft_untangle_matches_numpy():
    """The elementwise half of rfft_pow2's CUDA route (the untangle
    kernel, modelled), fed the half-length FFT of the even/odd-packed
    row."""
    x = np.random.default_rng(31).standard_normal((3, 4096))
    z = np.fft.fft(x[:, 0::2] + 1j * x[:, 1::2], axis=-1)
    assert _rel(untangle_model(z), np.fft.rfft(x, axis=-1)) < 1e-12


def tangle_model(x):
    """numpy model of csrc/fft_rows.cu irfft_tangle_kernel: thread k <=
    h/2 writes Z[k] and Z[h-k] (times 1/h) from X[k] and X[h-k], the DC
    and Nyquist imaginary parts dropped, W = exp(+2πi·k/n) from sin/cos
    of πk/h and W[h-k] = -conj(W[k])."""
    rows, h = x.shape[0], x.shape[1] - 1
    z = np.zeros((rows, h), np.complex128)
    x = np.array(x, np.complex128)
    x[:, 0], x[:, h] = x[:, 0].real, x[:, h].real
    k = np.arange(h // 2 + 1)
    xa, xb = x[:, k], x[:, h - k]
    w = np.exp(1j * np.pi * k / h)
    z[:, k] = (0.5 * (xa + np.conj(xb))
               + 1j * 0.5 * (xa - np.conj(xb)) * w) / h
    kk = k[1:]
    xa, xb, w = xa[:, 1:], xb[:, 1:], -np.conj(w[1:])
    z[:, h - kk] = (0.5 * (xb + np.conj(xa))
                    + 1j * 0.5 * (xb - np.conj(xa)) * w) / h
    return z


def test_irfft_tangle_matches_numpy():
    """The elementwise half of irfft_pow2's CUDA route (the tangle kernel,
    modelled), then the unnormalized backward FFT the kernel computes
    there: irfft as (even, odd) pairs; the DC and Nyquist imaginary parts
    are left nonzero and must be ignored."""
    spec = _c64((2, 1025), seed=32).astype(np.complex128)
    y = np.fft.ifft(tangle_model(spec), axis=-1) * 1024
    got = np.stack([y.real, y.imag], axis=-1).reshape(2, 2048)
    want = np.fft.irfft(spec, 2048, axis=-1)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()

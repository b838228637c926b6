"""K-MIXED (radiocore_tpu_torch/kernels/fft_mixed.py) on the CPU: its split
and plain version against the JAX package (``mixed_split``,
``fft_large_mixed_pallas`` in interpret mode), and its host plan — the
column pass (a-point DFT, twiddle W_n^{k1*j2}) and K-FFT's row passes
storing in natural order, with the buffer roles the kernels are given —
modelled in numpy against np.fft."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_fft_rows import emulate_passes

torch.set_num_threads(2)


def _c64(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _rel(got, want):
    got = np.asarray(got, dtype=np.complex128)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def column_stages(a):
    """csrc/fft_mixed.cu's stages of the a-point DFT, a = 2^p * q with q
    odd: (radix, Ns) with the q-point stage first (Ns = 1), then
    ceil(p/4) power-of-two stages, the larger radices first."""
    q, p = a, 0
    while q % 2 == 0:
        q, p = q // 2, p + 1
    stages, ns = [], 1
    if q > 1:
        stages.append((q, 1))
        ns = q
    if p:
        n_pow2 = (p + 3) // 4
        for st in range(n_pow2):
            bits = p // n_pow2 + (1 if st < p % n_pow2 else 0)
            stages.append((1 << bits, ns))
            ns <<= bits
    return stages


def column_dft(t, a, sign):
    """numpy model of the kernel's a-point DFT over axis 0 of the tile
    ``t`` (a, columns): Stockham stages of :func:`column_stages`; butterfly
    b of a radix-r stage reads rows b + m*a/r, twiddled by the W_a table
    entry (m*(b mod Ns)*a/(Ns*r)), takes the r-point DFT (radix 3 in
    registers, a direct sum over the W_a table for any other odd r,
    test_torch_fft_rows.dft_registers for powers of two) and writes
    output m at row (b - b mod Ns)*r + b mod Ns + m*Ns."""
    from test_torch_fft_rows import dft_registers
    wa = np.exp(sign * 2j * np.pi * np.arange(a) / a)
    v = np.asarray(t, np.complex128)
    for r, ns in column_stages(a):
        nb = a // r
        b = np.arange(nb)[:, None]
        m = np.arange(r)[None, :]
        bm = b % ns
        u = np.moveaxis(v[b + m * nb] * wa[m * bm * (a // (ns * r))][..., None],
                        -1, 0)          # (columns, nb, r)
        if r & (r - 1) == 0:
            u = dft_registers(u, sign)
        else:
            u = u @ wa[(np.arange(r)[:, None] * np.arange(r)[None, :]) % r
                       * nb]
        out = np.empty_like(v)
        out[(b - bm) * r + bm + m * ns] = np.moveaxis(u, 0, -1)
        v = out
    return v


def column_model(x, a, b, sign):
    """numpy model of csrc/fft_mixed.cu: T[k1, j2] = W_n^{k1*j2} *
    (a-point DFT over j1 of x[b*j1 + j2], :func:`column_dft`), stored at
    k1*b + j2; the outer twiddle is fft_mixed.mixed_table's two-level
    table, multiplied in float64 here."""
    from radiocore_tpu_torch.kernels.fft_rows import two_level_table
    n = a * b
    g = column_dft(np.asarray(x, np.complex128).reshape(a, b), a, sign)
    r = np.arange(a)[:, None] * np.arange(b)[None, :]
    assert r.max() < n          # the kernel forms k1*j2 with no reduction
    hi, lo = two_level_table(n, sign)
    w = hi[r >> 12].astype(np.complex128) * lo[r & 4095]
    assert np.abs(w - np.exp(sign * 2j * np.pi * r / n)).max() < 3e-7
    # float64 twiddles keep the plan models at 1e-12.
    return (g * np.exp(sign * 2j * np.pi * r / n)).ravel()


def emulate_mixed(x, a, b, sign):
    """The column pass, then the row passes with the buffer roles of
    ``_mixed_kernel`` (the column buffer aliases the rows' "x")."""
    from radiocore_tpu_torch.kernels.fft_mixed import (column_buffer,
                                                       row_passes)
    n = a * b
    passes = row_passes(a, b)
    col = column_buffer(passes)
    bufs = {name: np.zeros(n, np.complex128) for name in ("y", "s", "c")}
    bufs[col][:] = column_model(x, a, b, sign)
    bufs["x"] = bufs[col]
    # The rows may read their input only in the first pass.
    assert passes[0].src == "x"
    assert all("x" not in (p.src, p.dst) for p in passes[1:])
    if col == "y":
        assert passes[0].dst != "y"
    return emulate_passes(passes, None, sign, n, bufs=bufs)


@pytest.mark.parametrize("n", [3 << 23, 3 << 22, 3 << 12, 5 << 11, 1009,
                               1 << 24, 96 << 18, 7 << 17, 129 << 18, 250_000])
def test_mixed_split_matches_jax(n):
    from radiocore_tpu.kernels.fft_pallas import mixed_split as jax_split
    from radiocore_tpu_torch.kernels.fft_mixed import mixed_split
    assert mixed_split(n) == jax_split(n)


def test_band_split():
    from radiocore_tpu_torch.kernels.fft_mixed import mixed_split, row_passes
    assert mixed_split(3 << 23) == (96, 1 << 18)
    rows = row_passes(96, 1 << 18)
    assert [p.L for p in rows] == [512, 512]
    # The last pass's sub-FFTs are the 96 rows: a block stores runs of P
    # neighbouring outputs k1 .. k1 + P - 1 (P·L = FAST_BLOCK_POINTS).
    last = rows[-1]
    assert (last.S, last.P, last.os) == (96, 8, 1)
    assert last.ob1 == 96 and last.ok == 96 * 512


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("n", [3 << 12, 5 << 11])
def test_plain_matches_pallas(n, sign):
    from radiocore_tpu.kernels.fft_pallas import fft_large_mixed_pallas
    from radiocore_tpu_torch.kernels.fft_mixed import fft_large_mixed
    x = _c64((n,), seed=n)
    want = np.asarray(fft_large_mixed_pallas(jnp.asarray(x), sign=sign))
    got = fft_large_mixed(torch.from_numpy(x), sign).numpy()
    assert _rel(got, want.astype(np.complex128)) < 1e-4


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("a,b", [
    (96, 512),       # the band's a, one-pass rows
    (96, 8192),      # the band's a, two-pass rows (as at b = 2^18)
    (3, 4096),       # mixed_split(3 << 12)
    (5, 2048),       # mixed_split(5 << 11)
    (128, 16),       # the largest a
])
def test_kernel_plan_emulated(a, b, sign):
    n = a * b
    x = _c64((n,), seed=a + b).astype(np.complex128)
    got = emulate_mixed(x, a, b, sign)
    want = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * n
    assert _rel(got, want) < 1e-12


@pytest.mark.parametrize("sign", [-1.0, 1.0])
@pytest.mark.parametrize("a", [3, 5, 12, 96, 112, 127, 128])
def test_column_factorization_matches_numpy(a, sign):
    """The column pass's a = 2^p·q chain (radix q, then radix 2^p with the
    inner twiddles, in the kernel's order) against np.fft over j1."""
    stages = column_stages(a)
    assert np.prod([r for r, _ in stages]) == a and len(stages) <= 4
    # Each thread holds at most 16 points of a column per stage (8 warps).
    for r, _ in stages:
        per = -(-a // 8) if r % 2 and r != 3 else -(-(a // r) // 8) * r
        assert per <= 16
    x = _c64((a, 64), seed=a).astype(np.complex128)
    want = (np.fft.fft(x, axis=0) if sign < 0
            else np.fft.ifft(x, axis=0) * a)
    assert _rel(column_dft(x, a, sign), want) < 1e-12


def test_mixed_table_layout():
    from radiocore_tpu_torch.kernels.fft_mixed import mixed_table
    a, b = 96, 1 << 10
    for sign in (-1.0, 1.0):
        t = mixed_table(a, b, sign, torch.device("cpu")).numpy()
        n = a * b
        assert t.dtype == np.complex64 and t.shape == (a + 4096 + n // 4096
                                                       + (n % 4096 > 0),)
        np.testing.assert_allclose(
            t[:a], np.exp(sign * 2j * np.pi * np.arange(a) / a), atol=1e-7)
        r = np.array([0, 1, 4095, 4096, 12_345, n - 1])
        w = t[a + 4096 + (r >> 12)] * t[a + (r & 4095)]
        np.testing.assert_allclose(w, np.exp(sign * 2j * np.pi * r / n),
                                   atol=2.4e-7)


def test_three_pass_rows_emulated(monkeypatch):
    """Rows longer than SUB_MAX**2 take three passes and a column buffer
    of their own; shrink SUB_MAX so that a small row does."""
    from radiocore_tpu_torch.kernels import fft_mixed, fft_rows
    monkeypatch.setattr(fft_rows, "SUB_MAX", 16)
    monkeypatch.setattr(fft_rows, "BLOCK_POINTS", 64)
    fft_rows.plan.cache_clear()
    fft_mixed.row_passes.cache_clear()
    try:
        a, b = 12, 1024
        assert len(fft_mixed.row_passes(a, b)) == 3
        assert fft_mixed.column_buffer(fft_mixed.row_passes(a, b)) == "c"
        x = _c64((a * b,), seed=5).astype(np.complex128)
        assert _rel(emulate_mixed(x, a, b, -1.0), np.fft.fft(x)) < 1e-12
    finally:
        fft_rows.plan.cache_clear()
        fft_mixed.row_passes.cache_clear()


def test_leading_dims_and_pow2_rows():
    from radiocore_tpu_torch.kernels.fft_mixed import fft_large_mixed
    x = _c64((2, 3 << 12), seed=8)
    got = fft_large_mixed(torch.from_numpy(x)).numpy()
    assert _rel(got, np.fft.fft(x.astype(np.complex128), axis=-1)) < 1e-5
    y = _c64((4096,), seed=9)
    got = fft_large_mixed(torch.from_numpy(y), +1.0).numpy()
    assert _rel(got, np.fft.ifft(y.astype(np.complex128)) * 4096) < 1e-5


def test_rejects_and_no_kernel_off_cuda():
    """No split raises; a tensor on neither the CPU nor a CUDA device
    raises instead of falling back; the CPU route launches nothing."""
    from radiocore_tpu_torch.kernels import fft_mixed
    with pytest.raises(ValueError):
        fft_mixed.fft_large_mixed(torch.zeros(1009, dtype=torch.complex64))
    with pytest.raises(ValueError):
        fft_mixed.fft_large_mixed(torch.empty(3 << 12, dtype=torch.complex64,
                                              device="meta"))
    before = fft_mixed.launches.count
    fft_mixed.fft_large_mixed(torch.ones(3 << 12, dtype=torch.complex64))
    assert fft_mixed.launches.count == before


@pytest.mark.parametrize("n", [3 << 12, 3 * 65_536])
def test_ops_fft_non_pow2_matches_jax(n):
    from radiocore_tpu.ops import fft as jfft
    from radiocore_tpu_torch.ops import fft as tfft
    x = _c64((n,), seed=n)
    assert _rel(tfft.fft(torch.from_numpy(x)).numpy(),
                np.asarray(jfft.fft(jnp.asarray(x)))) < 1e-5
    assert _rel(tfft.ifft(torch.from_numpy(x)).numpy(),
                np.asarray(jfft.ifft(jnp.asarray(x)))) < 1e-5

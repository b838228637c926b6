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


def column_model(x, a, b, sign):
    """numpy model of csrc/fft_mixed.cu: T[k1, j2] = W_n^{k1*j2} *
    sum_j1 x[b*j1 + j2] * wa[(j1*k1) mod a], wa[e] = exp(sign*2πi*e/a),
    stored at k1*b + j2."""
    n = a * b
    wa = np.exp(sign * 2j * np.pi * np.arange(a) / a)
    j1 = np.arange(a)[:, None]
    k1 = np.arange(a)[None, :]
    g = wa[(j1 * k1) % a].T @ np.asarray(x, np.complex128).reshape(a, b)
    r = np.arange(a)[:, None] * np.arange(b)[None, :]
    assert r.max() < n          # the kernel forms k1*j2 with no reduction
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
    # neighbouring outputs k1 .. k1 + P - 1.
    last = rows[-1]
    assert (last.S, last.P, last.os) == (96, 32, 1)
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

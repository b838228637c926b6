"""K-XDEMOD and K-XDEMOD-SPEC (radiocore_tpu_torch/kernels/extract_demod.py)
on the CPU: the plain versions against the JAX Pallas kernels (interpret
mode) on the JAX suite's cells, the predicates against JAX's, and the
kernels' pass plan — extraction pass, demod pass with its halo row (how
x[t-1] crosses sub-FFT rows and block edges), keep pass — modelled in
numpy against the float64 plain versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_fft_rows import emulate_passes

torch.set_num_threads(2)

ATOL = 5e-5          # tests/test_extract_demod_pallas.py (atan2 of f32)
SPEC_REL = 3e-5      # the same file's spectrum bound, relative to the max


def _uniform_plan(c, m, n):
    half = n // 2 - m // 2
    return [int(-half + i * m) for i in range(c)]


def _spectrum(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.3


def _a0(c, m, n, shift=0):
    from radiocore_tpu_torch.ops.channelize import uniform_extraction_start
    shifts = tuple(-(o + shift) for o in _uniform_plan(c, m, n))
    a0 = uniform_extraction_start(n, shifts, m)
    assert a0 is not None
    return a0


# (c, m, n, offset added to every station): the JAX suite's cells.
CASES = [(4, 512, 2048, 0), (3, 512, 2048, 0), (4, 1024, 8192, 0),
         (4, 512, 4096, 100)]


@pytest.mark.parametrize("c,m,n,shift", CASES)
def test_plain_matches_pallas(c, m, n, shift):
    from radiocore_tpu.kernels.extract_demod_pallas import (
        extract_demod_rows_pallas)
    from radiocore_tpu_torch.kernels.extract_demod import extract_demod_rows
    a0 = _a0(c, m, n, shift)
    spec = _spectrum(n, seed=7 if shift else 3)
    want = np.asarray(extract_demod_rows_pallas(jnp.asarray(spec), a0, c, m))
    got = extract_demod_rows(torch.from_numpy(spec), a0, c, m).numpy()
    assert got.shape == want.shape == (c, m)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[:, 0] == 0.0)


@pytest.mark.parametrize("keep_bins", [None, 16_384 // 4 + 100])
def test_spec_plain_matches_pallas(keep_bins):
    """The port's K bins against the first K of JAX's (JAX rounds K up
    to its 8-row tiles)."""
    from radiocore_tpu.kernels.extract_demod_pallas import (
        extract_demod_spec_rows_pallas)
    from radiocore_tpu_torch.kernels.extract_demod import (
        extract_demod_spec_rows)
    c, m, n = 4, 16_384, 65_536
    a0 = _a0(c, m, n)
    spec = _spectrum(n, seed=13)
    want = np.asarray(extract_demod_spec_rows_pallas(
        jnp.asarray(spec), a0, c, m, keep_bins=keep_bins))
    got = extract_demod_spec_rows(torch.from_numpy(spec), a0, c, m,
                                  keep_bins=keep_bins).numpy()
    k = m if keep_bins is None else keep_bins
    assert got.shape == (c, k) and want.shape[1] >= k
    assert got.dtype == np.complex64
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got / scale, want[:, :k] / scale,
                               atol=SPEC_REL)


def test_predicates_match_jax():
    from radiocore_tpu.kernels import extract_demod_pallas as jx
    from radiocore_tpu_torch.kernels import extract_demod as tx
    for lg_m in range(7, 21):
        m = 1 << lg_m
        for n in (m, 2 * m, 4 * m, 3 * m, 96 * m, 2 * m + 512, 3 << 23):
            for c in (1, 2, 3, 4, 96, 97):
                assert tx.extract_demod_ok(n, m, c) == jx.extract_demod_ok(
                    n, m, c), (n, m, c)
                assert (tx.extract_demod_spec_ok(n, m, c)
                        == jx.extract_demod_spec_ok(n, m, c)), (n, m, c)
    for n, m, c in [(2048, 1000, 2), (3000, 1000, 3)]:
        assert tx.extract_demod_ok(n, m, c) == jx.extract_demod_ok(n, m, c)
    assert tx.extract_demod_spec_ok(3 << 23, 1 << 18, 96)


def test_rejects_and_no_kernel_off_cuda():
    from radiocore_tpu_torch.kernels import extract_demod as xd
    spec = torch.from_numpy(_spectrum(2048))
    with pytest.raises(ValueError):
        xd.extract_demod_rows(spec, 0, 5, 512)           # c > n/m
    with pytest.raises(ValueError):
        xd.extract_demod_spec_rows(spec, 0, 4, 512)      # A != C
    with pytest.raises(ValueError):
        xd.extract_demod_spec_rows(torch.from_numpy(_spectrum(65_536)), 0,
                                   4, 16_384, keep_bins=0)
    with pytest.raises(ValueError):
        xd.extract_demod_rows(torch.empty(2048, dtype=torch.complex64,
                                          device="meta"), 0, 4, 512)
    before = (xd.launches.count, xd.spec_launches.count)
    xd.extract_demod_rows(spec, 1024, 4, 512)
    xd.extract_demod_spec_rows(torch.from_numpy(_spectrum(65_536)), 0, 4,
                               16_384, keep_bins=100)
    assert (xd.launches.count, xd.spec_launches.count) == before


def demod_model(p, src, gain, spec):
    """numpy model of csrc/extract_demod.cu's demod pass: per station b1
    and block s0, the rows [(s0-1) mod S, s0, ..., s0+P-1] (halo first)
    are backward-transformed; row s's neighbour x[t-1] is the row before
    at the same k, and for s = 0 the halo (row S-1) at k-1; t = 0 gives 0.
    SPEC then takes the forward DFT over k and the twiddle W_m^{s*k}."""
    L, P, S = p.L, p.P, p.S
    out = np.zeros(p.B1 * p.ib1, np.complex128 if spec else np.float64)
    k = np.arange(L)
    for b1 in range(p.B1):
        for s0 in range(0, S, P):
            rows = np.array([(s0 - 1) % S] + list(range(s0, s0 + P)))
            v = np.fft.ifft(src[b1 * p.ib1 + rows[:, None] * p.is_
                                + k[None, :] * p.ij], axis=-1) * L
            cur, prv = v[1:], v[:-1].copy()
            if s0 == 0:
                prv[0] = np.roll(v[0], 1)
            prod = -(cur * np.conj(prv))
            q = gain * np.arctan2(prod.imag, prod.real)
            if s0 == 0:
                q[0, 0] = 0.0
            s = s0 + np.arange(P)
            if spec:
                q = np.fft.fft(q, axis=-1) * np.exp(
                    -2j * np.pi * ((s[:, None] * k[None, :]) % p.tw_n)
                    / p.tw_n)
            out[b1 * p.ob1 + s[:, None] * p.os + k[None, :] * p.ok] = q
    return out


@pytest.mark.parametrize("block_points", [None, 1024])
@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("c,m,n,a0", [
    (3, 8192, 1 << 15, 12_345),       # unaligned, wraps at n
    (2, 16_384, 1 << 16, 40_000),     # unaligned, wraps at n
])
def test_kernel_plan_emulated(c, m, n, a0, spec, block_points, monkeypatch):
    """The passes K-XDEMOD(-SPEC) launches, modelled in numpy, against
    the float64 plain versions. With 1024 points per block the demod pass
    has 8 or 16 blocks per station, so x[t-1] crosses block edges through
    the halo row as well as at k1 = 0."""
    from radiocore_tpu_torch.kernels import extract_demod as xd
    from radiocore_tpu_torch.kernels import fft_rows
    if block_points:
        monkeypatch.setattr(fft_rows, "BLOCK_POINTS", block_points)
    xd.plan.cache_clear()
    try:
        keep = m // 4 + 100 if spec else None
        pl = xd.plan(m, c, keep)
        assert pl.demod.S % pl.demod.P == 0
        assert pl.demod.P * pl.demod.L <= fft_rows.BLOCK_POINTS
        if block_points:
            assert pl.demod.S // pl.demod.P >= 8
        spectrum = _spectrum(n, seed=c + m).astype(np.complex128)
        s_norm = 1.0 / n
        gain = 1.0 / np.pi

        def load(src, off):
            kk = off & (m - 1)
            w = 0.5 * s_norm * (1 + np.cos(2 * np.pi * (kk - m // 2) / n))
            v = src[(a0 + off) % n]
            v = v + np.where(kk == 0, src[(a0 + off + m) % n], 0)
            return v * w

        bufs = {"x": spectrum, "s": np.zeros(c * m, np.complex128)}
        emulate_passes([pl.first], None, +1.0, c * m, modes=[(1, 0)],
                       load_fn=load, bufs=bufs)
        assert pl.first.src == "x" and pl.first.dst == pl.demod.src == "s"
        out = demod_model(pl.demod, bufs["s"], gain, spec)
        spec_t = torch.from_numpy(spectrum)
        if not spec:
            assert pl.keep is None and pl.demod.dst == "y"
            want = xd.extract_demod_rows_plain(spec_t, a0, c, m).numpy()
            np.testing.assert_allclose(out.reshape(c, m), want, atol=1e-9)
            return
        p3 = pl.keep
        assert pl.demod.dst == p3.src == "t" and p3.dst == "y"
        bufs = {"t": out, "y": np.zeros(c * keep, np.complex128)}
        got = emulate_passes([p3], None, -1.0, c * keep, bufs=bufs)
        want = xd.extract_demod_spec_rows_plain(spec_t, a0, c, m,
                                                keep_bins=keep).numpy()
        np.testing.assert_allclose(got.reshape(c, keep), want,
                                   atol=1e-9 * np.abs(want).max())
    finally:
        xd.plan.cache_clear()


def test_main_path_plan():
    from radiocore_tpu_torch.kernels import extract_demod as xd
    pl = xd.plan(1 << 18, 96, 63_601)
    assert [pl.first.L, pl.demod.L, pl.keep.L] == [512, 512, 512]
    # P + 1 rows (the halo) of 512 points within the kernel's block.
    assert pl.demod.P == 16 and pl.demod.S == 512
    assert pl.keep.ob1 == 63_601 and pl.keep.keep == 63_601

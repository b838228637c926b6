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

from test_torch_extract import extraction_load
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


def emulate_extract_demod(spectrum, a0, c, m, n, gain, keep, group,
                          lanes=1):
    """K-XDEMOD(-SPEC)'s grouped schedule in numpy: the launches of
    ``grouped_launches`` in order over ONE scratch set (``s`` and, for
    SPEC, ``t``) of ``group`` stations per lane that every group of the
    lane overwrites, the result written at each group's offset. Returns
    it and the number of launches."""
    from radiocore_tpu_torch.kernels import extract_demod as xd
    from radiocore_tpu_torch.kernels.extract import grouped_launches
    pl = xd.plan(m, c, keep)
    width = keep or m
    y = np.full(c * width, np.nan, np.complex128 if keep else np.float64)
    s = np.full(lanes * group * m, np.nan, np.complex128)
    t = np.full(lanes * group * m, np.nan, np.complex128)
    launches = list(grouped_launches(pl.passes, c, group, a0, n, m, lanes))
    for i, (p, a0_g, off, at) in enumerate(launches):
        cg = p.B1
        role = i % len(pl.passes)
        if role == 0:
            assert (p.src, p.dst) == ("x", "s")
            emulate_passes([p], None, +1.0, cg * m, modes=[(1, 0)],
                           load_fn=extraction_load(a0_g, m, n, 1.0 / n),
                           bufs={"x": spectrum, "s": s[at:at + cg * m]})
        elif role == 1:
            assert p.src == "s" and p.dst == ("t" if keep else "y")
            out = demod_model(p, s[at:], gain, bool(keep))
            if keep:
                assert off == 0
                t[at:at + cg * m] = out
            else:
                y[off:off + cg * m] = out
        else:
            assert (p.src, p.dst) == ("t", "y")
            emulate_passes([p], None, -1.0, cg * keep,
                           bufs={"t": t[at:], "y": y[off:off + cg * keep]})
    return y.reshape(c, width), len(launches)


@pytest.mark.parametrize("group", [1, 2, None])
@pytest.mark.parametrize("block_points", [None, 1024])
@pytest.mark.parametrize("mode", ["quad", "spec_keep", "spec_full"])
@pytest.mark.parametrize("c,m,n,a0", [
    (3, 8192, 1 << 15, 12_345),       # unaligned, wraps at n
    (2, 16_384, 1 << 16, 40_000),     # unaligned, wraps at n
])
def test_kernel_plan_emulated(c, m, n, a0, mode, block_points, group,
                              monkeypatch):
    """The passes K-XDEMOD(-SPEC) launches, modelled in numpy, against
    the float64 plain versions: per group of G stations (1, 2 — which
    does not divide c = 3 — and the whole batch) over one reused scratch
    set, with and without ``keep_bins``. With 1024 points per block the
    demod pass has 8 or 16 blocks per station, so x[t-1] crosses block
    edges through the halo row as well as at k1 = 0."""
    from radiocore_tpu_torch.kernels import extract_demod as xd
    from radiocore_tpu_torch.kernels import fft_rows
    if block_points:
        monkeypatch.setattr(fft_rows, "BLOCK_POINTS", block_points)
    xd.plan.cache_clear()
    try:
        keep = {"quad": None, "spec_keep": m // 4 + 100, "spec_full": m}[mode]
        pl = xd.plan(m, c, keep)
        assert pl.demod.S % pl.demod.P == 0
        assert pl.demod.P * pl.demod.L <= fft_rows.BLOCK_POINTS
        if block_points:
            assert pl.demod.S // pl.demod.P >= 8
        assert [p.B1 for p in pl.passes] == [c] * len(pl.passes)
        spectrum = _spectrum(n, seed=c + m).astype(np.complex128)
        group = c if group is None else group
        got, launches = emulate_extract_demod(spectrum, a0, c, m, n,
                                              1.0 / np.pi, keep, group)
        assert launches == len(pl.passes) * -(-c // group)
        spec_t = torch.from_numpy(spectrum)
        if not keep:
            assert pl.keep is None
            want = xd.extract_demod_rows_plain(spec_t, a0, c, m).numpy()
            np.testing.assert_allclose(got, want, atol=1e-9)
            return
        want = xd.extract_demod_spec_rows_plain(spec_t, a0, c, m,
                                                keep_bins=keep).numpy()
        np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max())
    finally:
        xd.plan.cache_clear()


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("group", [1, 2, 3])
@pytest.mark.parametrize("keep_bins", [None, 16_384 // 4 + 100])
def test_grouped_spec_matches_pallas(keep_bins, group, lanes):
    """The grouped SPEC schedule (c = 3, a0 wrapping at n inside the group
    of G = 2) against the JAX Pallas kernel in interpret mode, at the JAX
    suite's bound."""
    from radiocore_tpu.kernels.extract_demod_pallas import (
        extract_demod_spec_rows_pallas)
    c, m, n = 3, 16_384, 65_536
    a0 = 40_000
    spec = _spectrum(n, seed=17)
    keep = m if keep_bins is None else keep_bins
    want = np.asarray(extract_demod_spec_rows_pallas(
        jnp.asarray(spec), a0, c, m, keep_bins=keep_bins))[:, :keep]
    got, _ = emulate_extract_demod(spec.astype(np.complex128), a0, c, m, n,
                                   1.0 / np.pi, keep, group, lanes)
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got / scale, want / scale, atol=SPEC_REL)


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("group", [1, 2, 3])
def test_grouped_quad_matches_pallas(group, lanes):
    """The grouped K-XDEMOD schedule against the JAX Pallas kernel."""
    from radiocore_tpu.kernels.extract_demod_pallas import (
        extract_demod_rows_pallas)
    c, m, n = 3, 8192, 32_768
    a0 = 20_000
    spec = _spectrum(n, seed=19)
    want = np.asarray(extract_demod_rows_pallas(jnp.asarray(spec), a0, c, m))
    got, _ = emulate_extract_demod(spec.astype(np.complex128), a0, c, m, n,
                                   1.0 / np.pi, None, group, lanes)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[:, 0] == 0.0)


@pytest.mark.parametrize("lg_m", range(8, 19))
def test_demod_block_within_kernel_limits(lg_m):
    """The demod plan's (P, threads) pairs against the kernel's limits:
    P a power of two dividing the rows, (P + 1)·n2/16 threads within the
    kernel's launch bounds (288 threads: 8 rows of 512 points and the
    halo), and the block's shared memory within an SM's at the three
    blocks per SM it is built for."""
    from radiocore_tpu_torch.kernels import extract_demod as xd
    m = 1 << lg_m
    pl = xd.plan(m, 4)
    p, n2 = pl.demod.P, pl.demod.L
    assert p >= 1 and p & (p - 1) == 0 and pl.demod.S % p == 0
    assert p <= xd.DEMOD_ROWS
    threads = xd.demod_threads(p, n2)
    assert threads == (p + 1) * n2 // 16 <= xd.DEMOD_MAX_THREADS == 288
    if m == 1 << 18:
        assert (p, threads) == (8, 288)
    smem = 8 * (p + 1) * (n2 + n2 // 16 + 1)      # row_pitch(n2) points
    assert 3 * (smem + 1024) <= 227 * 1024
    assert 16 <= n2 <= 512 and pl.first.L * n2 == m


def test_main_path_plan():
    from radiocore_tpu_torch.kernels import extract_demod as xd
    pl = xd.plan(1 << 18, 96, 63_601)
    assert [pl.first.L, pl.demod.L, pl.keep.L] == [512, 512, 512]
    # P + 1 rows (the halo) of 512 points within the kernel's block.
    assert pl.demod.P == 8 and pl.demod.S == 512
    assert pl.keep.ob1 == 63_601 and pl.keep.keep == 63_601

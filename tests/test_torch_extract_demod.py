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


def atan2_origin0(y, x):
    """float64 ``arctan2`` with the kernels' convention at the origin:
    0 whatever the zeros' signs."""
    return np.where((y == 0) & (x == 0), 0.0, np.arctan2(y, x))


def demod_model(p, src, gain, spec, atan2=atan2_origin0, out_offset=0):
    """numpy model of csrc/extract_demod.cu's demod pass: per station b1
    and block s0, the buffer rows [(s0-1) mod S, s0, ..., s0+P-1] (halo
    first) are backward-transformed. The threads of buffer row r > 0 hold
    its points and demodulate them against buffer row r - 1 at the same k
    (for s = 0: the halo, row S-1, at k-1; t = 0 gives 0). SPEC then takes
    the forward DFT over k and the twiddle W_m^{s*k}, s fastest in the
    scratch. The quad is staged row by row at ``quad_pitch`` floats and
    leaves as the kernel stores it: thread tq of the P*L/16 that are left
    takes rows 4j .. 4j+3 at one k, four times (16-byte stores, where P
    >= 4, the run is contiguous and 16-byte aligned: ``out_offset`` is
    the result's offset in floats from such a boundary), or 16 single
    floats with s fastest."""
    from radiocore_tpu_torch.kernels import extract_demod as xd
    L, P, S = p.L, p.P, p.S
    T = L // 16
    out = np.full(p.B1 * p.ib1, np.nan, np.complex128 if spec else np.float64)
    k = np.arange(L)
    for b1 in range(p.B1):
        for s0 in range(0, S, P):
            rows = np.array([(s0 - 1) % S] + list(range(s0, s0 + P)))
            v = np.fft.ifft(src[b1 * p.ib1 + rows[:, None] * p.is_
                                + k[None, :] * p.ij], axis=-1) * L
            q = np.zeros((P, L))
            for r in range(1, P + 1):
                first = rows[r] == 0
                prv = np.roll(v[r - 1], 1) if first else v[r - 1]
                prod = -(v[r] * np.conj(prv))
                q[r - 1] = gain * atan2(prod.imag, prod.real)
                if first:
                    q[r - 1, 0] = 0.0
            s = s0 + np.arange(P)
            if spec:
                q = np.fft.fft(q, axis=-1) * np.exp(
                    -2j * np.pi * ((s[:, None] * k[None, :]) % p.tw_n)
                    / p.tw_n)
                out[b1 * p.ob1 + s[:, None] * p.os + k[None, :] * p.ok] = q
                continue
            qp = xd.quad_pitch(L, P)
            qs = np.full(P * qp, np.nan)
            for r in range(P):
                qs[r * qp + k] = q[r]
            base = b1 * p.ob1 + s0 * p.os
            tq = np.arange(P * T)
            if (P >= 4 and p.os == 1 and p.ok % 4 == 0
                    and (out_offset + base) % 4 == 0):
                per_k = P // 4
                j, kk = tq % per_k, tq // per_k
                for it in range(4):
                    kq = kk + it * (P * T // per_k)
                    for i in range(4):
                        out[base + 4 * j + i + kq * p.ok] = qs[
                            (4 * j + i) * qp + kq]
            else:
                for it in range(16):
                    idx = tq + it * P * T
                    pp, kq = idx % P, idx // P
                    out[base + pp * p.os + kq * p.ok] = qs[pp * qp + kq]
    assert not np.isnan(out[:p.B1 * p.ib1]).any()
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
    # P + 1 rows of row_pitch(n2) points; the quad's P staged rows fit in
    # their place.
    smem = xd.demod_smem_bytes(p, n2)
    assert smem == 8 * (p + 1) * (n2 + n2 // 16 + 1)
    assert 4 * p * xd.quad_pitch(n2, p) <= smem
    assert 3 * (smem + 1024) <= 227 * 1024
    assert 16 <= n2 <= 512 and pl.first.L * n2 == m
    # The staged quad's pitch: the P/4 row groups that a warp of the store
    # reads start 32/(P/4) banks apart, so its 32 lanes hit 32 banks.
    if p >= 4:
        per_k = p // 4
        banks = {(4 * (lane % per_k) * xd.quad_pitch(n2, p) + lane // per_k)
                 % 32 for lane in range(32)}
        assert len(banks) == 32


def test_main_path_plan():
    from radiocore_tpu_torch.kernels import extract_demod as xd
    pl = xd.plan(1 << 18, 96, 63_601)
    assert [pl.first.L, pl.demod.L, pl.keep.L] == [512, 512, 512]
    # P + 1 rows (the halo) of 512 points within the kernel's block.
    assert pl.demod.P == 8 and pl.demod.S == 512
    assert pl.keep.ob1 == 63_601 and pl.keep.keep == 63_601
    # K-XDEMOD's demod pass: the same block, its staged quad rows 516
    # floats apart, and 16-byte stores of the quad (runs of 8 rows, the
    # k stride a multiple of 4).
    quad = xd.plan(1 << 18, 96).demod
    assert (quad.P, quad.L, quad.os, quad.ok) == (8, 512, 1, 512)
    assert xd.demod_threads(quad.P, quad.L) == 288 == xd.DEMOD_MAX_THREADS
    assert xd.quad_pitch(quad.L, quad.P) == 516
    assert xd.demod_smem_bytes(8, 512) == 8 * 9 * 545 >= 4 * 8 * 516


@pytest.mark.parametrize("out_offset", [0, 2])
@pytest.mark.parametrize("rows", [1, 2, 4, 8, 16])
def test_demod_store_emulated_every_block(rows, out_offset, monkeypatch):
    """The in-register demod and the staged quad store for every P the
    plan can take (1 and 2: single floats; 4, 8, 16: 16-byte stores of
    four rows), and from a result that is off a 16-byte boundary (single
    floats again), against the float64 plain version."""
    from radiocore_tpu_torch.kernels import extract_demod as xd
    monkeypatch.setattr(xd, "DEMOD_ROWS", rows)
    monkeypatch.setattr(xd, "DEMOD_MAX_THREADS", 1024)
    xd.plan.cache_clear()
    try:
        c, m, n, a0 = 2, 4096, 1 << 14, 5000
        pl = xd.plan(m, c, None)
        assert pl.demod.P == rows
        spectrum = _spectrum(n, seed=rows).astype(np.complex128)
        s = np.full(c * m, np.nan, np.complex128)
        emulate_passes([pl.first], None, +1.0, c * m, modes=[(1, 0)],
                       load_fn=extraction_load(a0, m, n, 1.0 / n),
                       bufs={"x": spectrum, "s": s})
        got = demod_model(pl.demod, s, 1.0 / np.pi, False,
                          out_offset=out_offset).reshape(c, m)
        want = xd.extract_demod_rows_plain(torch.from_numpy(spectrum), a0,
                                           c, m).numpy()
        np.testing.assert_allclose(got, want, atol=1e-9)
    finally:
        xd.plan.cache_clear()


def _atan_points(seed=0, n=1 << 18):
    """Seeded float32 points: every magnitude from 1e-30 to 1e30 at any
    angle, component ratios up to 1e8 either way, subnormals, the axes and
    the origin with either sign of zero."""
    rng = np.random.default_rng(seed)
    mag, th = 10.0 ** rng.uniform(-30, 30, n), rng.uniform(-np.pi, np.pi, n)
    x1, y1 = mag * np.cos(th), mag * np.sin(th)
    x2 = rng.standard_normal(n)
    y2 = x2 * 10.0 ** rng.uniform(-8, 8, n)
    sub, th = 10.0 ** rng.uniform(-45, -37, n), rng.uniform(-np.pi, np.pi, n)
    x3, y3 = sub * np.cos(th), sub * np.sin(th)
    zeros = np.array([0.0, -0.0])
    vals = np.array([0.0, -0.0, 1.0, -1.0, 1e-30, -1e30, 3e-42, -3e-42])
    x4, y4 = [g.ravel() for g in np.meshgrid(vals, vals)]
    x5, y5 = [g.ravel() for g in np.meshgrid(zeros, zeros)]
    x = np.concatenate([x1, x2, x3, x4, x5]).astype(np.float32)
    y = np.concatenate([y1, y2, y3, y4, y5]).astype(np.float32)
    return y, x


def _atan_reference(y, x):
    """float64 ``arctan2`` of the float32 inputs under the kernels'
    conventions: a zero y counts as +0 and the origin gives 0."""
    y64 = np.where(y == 0, 0.0, y.astype(np.float64))
    return atan2_origin0(y64, x.astype(np.float64))


def test_discriminator_model_matches_float64():
    """The numpy float32 model of the kernels' ``atan2_fast``, coefficient
    for coefficient what csrc/extract_demod.cu holds, against float64
    ``arctan2``: within 2e-6 rad everywhere."""
    from radiocore_tpu_torch.kernels import extract_demod as xd
    y, x = _atan_points()
    got = xd.atan2_fast_model(y, x)
    assert got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - _atan_reference(y, x))
    assert err.max() <= 2e-6, err.max()
    # The CPU route of the wrapper is the model.
    np.testing.assert_array_equal(
        xd.atan2_fast(torch.from_numpy(y), torch.from_numpy(x)).numpy(), got)


def test_discriminator_coefficients_are_the_kernels():
    """``ATAN_Q`` is, literal for literal, the polynomial in the CUDA
    source (highest power first)."""
    import re
    from radiocore_tpu_torch.kernels import build, extract_demod as xd
    src = (build.CSRC_DIR / "extract_demod.cu").read_text()
    body = src[src.index("float atan2_fast("):src.index("float discriminate(")]
    first = re.search(r"float q = (-?[0-9.e-]+)f;", body).group(1)
    rest = re.findall(r"q = fmaf\(q, s, (-?[0-9.e-]+)f\);", body)
    assert tuple(float(v) for v in [first] + rest) == xd.ATAN_Q
    assert len(xd.ATAN_Q) == 6


@pytest.mark.parametrize("y,x,want", [
    (0.0, 0.0, 0.0), (-0.0, 0.0, 0.0), (0.0, -0.0, 0.0), (-0.0, -0.0, 0.0),
    (0.0, 2.0, 0.0), (-0.0, 2.0, 0.0), (0.0, -2.0, np.pi), (-0.0, -2.0, np.pi),
    (3.0, 0.0, np.pi / 2), (3.0, -0.0, np.pi / 2), (-3.0, 0.0, -np.pi / 2),
    (1.0, 1.0, np.pi / 4), (-1.0, -1.0, -3 * np.pi / 4),
])
def test_discriminator_model_axes_and_origin(y, x, want):
    """Exactly 0 at the origin whatever the zeros' signs; on the axes
    ``np.arctan2`` with a zero y taken as +0, as the JAX ``atan2_poly``."""
    from radiocore_tpu.kernels.extract_demod_pallas import atan2_poly
    from radiocore_tpu_torch.kernels import extract_demod as xd
    got = float(xd.atan2_fast_model(np.float32(y), np.float32(x)))
    jax_got = float(atan2_poly(jnp.float32(y), jnp.float32(x)))
    if x == 0 and y == 0:
        assert got == 0.0 and jax_got == 0.0
    assert abs(got - want) <= 2e-6
    assert abs(got - jax_got) <= 3e-6


def test_discriminator_model_matches_jax_atan2_poly():
    """Against the JAX kernels' own discriminator on normal float32
    inputs (XLA flushes subnormals, which ``atan2_poly`` guards): within
    3e-6 rad."""
    from radiocore_tpu.kernels.extract_demod_pallas import atan2_poly
    from radiocore_tpu_torch.kernels import extract_demod as xd
    y, x = _atan_points(seed=1)
    normal = ((np.abs(x) >= 1e-30) | (x == 0)) & ((np.abs(y) >= 1e-30)
                                                  | (y == 0))
    y, x = y[normal], x[normal]
    got = xd.atan2_fast_model(y, x).astype(np.float64)
    want = np.asarray(atan2_poly(jnp.asarray(y), jnp.asarray(x)),
                      dtype=np.float64)
    assert np.abs(got - want).max() <= 3e-6


def _dead_spectrum(c, m, n, a0, dead, seed):
    """A spectrum in which station ``dead``'s run, and the bin after it
    that its Nyquist fold reads, are exactly zero."""
    spec = _spectrum(n, seed=seed)
    spec[(a0 + dead * m + np.arange(m + 1)) % n] = 0
    return spec


def test_dead_station_quad_is_zero_as_in_jax():
    """A station whose bins are exactly zero demodulates to exactly 0 in
    the JAX kernel (interpret mode), in the port's plain version and in
    the numpy model of the kernel's pass with its own discriminator; the
    live stations keep the suite's tolerance."""
    from radiocore_tpu.kernels.extract_demod_pallas import (
        extract_demod_rows_pallas)
    from radiocore_tpu_torch.kernels import extract_demod as xd
    c, m, n, dead = 4, 512, 2048, 2
    a0 = _a0(c, m, n)
    spec = _dead_spectrum(c, m, n, a0, dead, seed=23)
    want = np.asarray(extract_demod_rows_pallas(jnp.asarray(spec), a0, c, m))
    got = xd.extract_demod_rows(torch.from_numpy(spec), a0, c, m).numpy()
    assert np.all(want[dead] == 0.0) and np.all(got[dead] == 0.0)
    live = [i for i in range(c) if i != dead]
    assert np.abs(want[live]).max() > 0.1
    np.testing.assert_allclose(got[live], want[live], atol=ATOL)

    def disc(y, x):
        return xd.atan2_fast_model(y, x).astype(np.float64)

    pl = xd.plan(m, c, None)
    s = np.full(c * m, np.nan, np.complex128)
    emulate_passes([pl.first], None, +1.0, c * m, modes=[(1, 0)],
                   load_fn=extraction_load(a0, m, n, 1.0 / n),
                   bufs={"x": spec.astype(np.complex128), "s": s})
    model = demod_model(pl.demod, s, 1.0 / np.pi, False,
                        atan2=disc).reshape(c, m)
    assert np.all(model[dead] == 0.0)
    np.testing.assert_allclose(model[live], want[live], atol=ATOL)


def test_dead_station_spectrum_is_zero_as_in_jax():
    """The same for the SPEC kernels: a dead station's kept bins are
    exactly 0 in the JAX kernel and in the port's plain version."""
    from radiocore_tpu.kernels.extract_demod_pallas import (
        extract_demod_spec_rows_pallas)
    from radiocore_tpu_torch.kernels import extract_demod as xd
    c, m, n, dead, keep = 4, 16_384, 65_536, 3, 16_384 // 4 + 100
    a0 = _a0(c, m, n)
    spec = _dead_spectrum(c, m, n, a0, dead, seed=29)
    want = np.asarray(extract_demod_spec_rows_pallas(
        jnp.asarray(spec), a0, c, m, keep_bins=keep))[:, :keep]
    got = xd.extract_demod_spec_rows(torch.from_numpy(spec), a0, c, m,
                                     keep_bins=keep).numpy()
    assert np.all(want[dead] == 0) and np.all(got[dead] == 0)
    live = [i for i in range(c) if i != dead]
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[live] / scale, want[live] / scale,
                               atol=SPEC_REL)

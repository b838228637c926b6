"""K-EXTRACT and the channelizer on the CPU: the plain K-EXTRACT and
the port's ``make_extractor`` (both lowerings) against the JAX Pallas
kernel (interpret mode) and the JAX ``make_extractor``, and the CUDA
kernel's pass plan (extraction load, flip store) emulated in numpy."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_fft_rows import emulate_passes

torch.set_num_threads(2)

ATOL = 2e-6   # the JAX suite's own bound (tests/test_extract_pallas.py)


def _uniform_plan(c, m, n):
    half = n // 2 - m // 2
    return [int(-half + i * m) for i in range(c)]


def _spectrum(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n)
            + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.3


# (c, m, n, offset added to every station): the JAX suite's cases, an
# unaligned a0, and the last station's fold wrapping to spectrum[a0].
CASES = [(4, 512, 2048, 0), (3, 512, 2048, 0), (4, 1024, 8192, 0),
         (4, 512, 4096, 100), (4, 256, 1024, 0)]


@pytest.mark.parametrize("c,m,n,shift", CASES)
def test_plain_kernel_matches_pallas(c, m, n, shift):
    from radiocore_tpu.kernels.extract_pallas import extract_rows_pallas
    from radiocore_tpu_torch.kernels.extract import extract_rows
    from radiocore_tpu_torch.ops.channelize import uniform_extraction_start
    shifts = tuple(-(o + shift) for o in _uniform_plan(c, m, n))
    a0 = uniform_extraction_start(n, shifts, m)
    assert a0 is not None
    spec = _spectrum(n)
    s_norm = 1.0 / ((n / m) * m)
    want = np.asarray(extract_rows_pallas(jnp.asarray(spec), a0, c, m,
                                          s_norm))
    got = extract_rows(torch.from_numpy(spec), a0, c, m, s_norm).numpy()
    assert got.shape == (c, m)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("c,m,n,shift", CASES)
def test_make_extractor_uniform_matches_jax(c, m, n, shift):
    from radiocore_tpu.ops import channelize as jch
    from radiocore_tpu_torch.ops import channelize as tch
    shifts = tuple(-(o + shift) for o in _uniform_plan(c, m, n))
    spec = _spectrum(n, seed=7)
    jch.make_extractor.cache_clear()
    want = np.asarray(jch.make_extractor(n, shifts, m)(jnp.asarray(spec)))
    got = tch.make_extractor(n, shifts, m)(torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("m", [512, 513])
def test_make_extractor_slices_matches_jax(m):
    """A non-uniform plan takes the per-slice lowering (even and odd m)."""
    from radiocore_tpu.ops import channelize as jch
    from radiocore_tpu_torch.ops import channelize as tch
    n = 8192
    shifts = (0, 1500, -2600, 3999)
    assert tch.uniform_extraction_start(n, shifts, m) is None
    spec = _spectrum(n, seed=9)
    jch.make_extractor.cache_clear()
    want = np.asarray(jch.make_extractor(n, shifts, m)(jnp.asarray(spec)))
    got = tch.make_extractor(n, shifts, m)(torch.from_numpy(spec)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_make_extractor_batched_spectrum():
    from radiocore_tpu.ops import channelize as jch
    from radiocore_tpu_torch.ops import channelize as tch
    c, m, n = 4, 512, 2048
    shifts = tuple(-o for o in _uniform_plan(c, m, n))
    spec = np.stack([_spectrum(n, seed=s) for s in (1, 2)])
    jch.make_extractor.cache_clear()
    want = np.asarray(jch.make_extractor(n, shifts, m)(jnp.asarray(spec)))
    got = tch.make_extractor(n, shifts, m)(torch.from_numpy(spec)).numpy()
    assert got.shape == (2, c, m)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_extract_ok_matches_jax():
    from radiocore_tpu.kernels import extract_pallas as jx
    from radiocore_tpu_torch.kernels import extract as tx
    for n, m, c in [(2048, 512, 4), (2048, 512, 5), (1 << 24, 1 << 18, 64),
                    (3 << 23, 1 << 18, 96), (4096, 1000, 4), (512, 512, 1),
                    (1 << 21, 1 << 20, 2)]:
        assert tx.extract_ok(n, m, c) == jx.extract_ok(n, m, c)


def extraction_load(a0, m, n, s_norm):
    """numpy model of fft_common.cuh extract_load for a start bin a0."""
    def load(src, off):
        k = off & (m - 1)
        w = 0.5 * s_norm * (1 + np.cos(2 * np.pi * (k - m // 2) / n))
        v = src[(a0 + off) % n]
        v = v + np.where(k == 0, src[(a0 + off + m) % n], 0)
        return v * w
    return load


def emulate_extract(spec, a0, c, m, n, s_norm, group, lanes=1):
    """K-EXTRACT's grouped schedule in numpy: the launches of
    ``grouped_launches`` in order, over ONE scratch of ``group`` stations
    per lane that every group of the lane overwrites (stale data of the
    group before stays in it), the result written at each group's
    offset."""
    from radiocore_tpu_torch.kernels.extract import (extract_passes,
                                                     grouped_launches)
    plan = extract_passes(m, c)
    y = np.full(c * m, np.nan, np.complex128)
    scratch = np.full(lanes * group * m, np.nan, np.complex128)
    launches = list(grouped_launches([p for p, _, _ in plan], c, group, a0,
                                     n, m, lanes))
    for i, (p, a0_g, off, at) in enumerate(launches):
        _, load, store = plan[i % len(plan)]
        size = c * m if len(plan) == 1 else p.B1 * m
        assert at + size <= max(scratch.size, size)
        emulate_passes([p], None, +1.0, size, modes=[(load, store)],
                       load_fn=extraction_load(a0_g, m, n, s_norm),
                       bufs={"x": spec, "s": scratch[at:at + size],
                             "y": y[off:off + size]})
    return y.reshape(c, m), len(launches)


@pytest.mark.parametrize("c,m,n,a0", [
    (4, 512, 2048, 1024),          # one pass, aligned
    (4, 256, 1024, 640),           # one pass, unaligned, last run wraps
    (3, 1 << 13, 1 << 15, 1 << 14),  # two passes (4096 < m)
    (2, 1 << 13, 1 << 14, 12_345),   # two passes, unaligned, wraps
])
def test_kernel_plan_emulated(c, m, n, a0):
    """The passes K-EXTRACT launches, modelled in numpy (extraction
    load on the first pass, (-1)^t flip on the last), against the
    float64 plain version; the passes over the whole batch (G = c)."""
    from radiocore_tpu_torch.kernels.extract import (extract_passes,
                                                     extract_rows_plain)
    spec = _spectrum(n, seed=c + m).astype(np.complex128)
    s_norm = 1.0 / n
    plan = extract_passes(m, c)
    assert len(plan) == (1 if m <= 4096 else 2)
    got, launches = emulate_extract(spec, a0, c, m, n, s_norm, c)
    assert launches == len(plan)
    want = extract_rows_plain(torch.from_numpy(spec), a0, c, m,
                              s_norm).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("group", [1, 2, 3, 5])
@pytest.mark.parametrize("c,m,n,a0", [
    (3, 1 << 13, 1 << 15, 1 << 14),   # aligned; G = 2 does not divide c
    (3, 1 << 13, 1 << 15, 20_000),    # station 1 wraps at n inside a group
    (5, 1 << 13, 5 << 13, 30_001),    # n not a power of two, c = n/m
])
def test_grouped_schedule_emulated(c, m, n, a0, group, lanes):
    """The station-group schedule (G ∈ {1, 2, c} and a G that does not
    divide c; one lane or two) with one reused G-station scratch per
    lane, against the float64 plain version and against the JAX Pallas
    kernel (interpret mode)."""
    from radiocore_tpu.kernels.extract_pallas import extract_rows_pallas
    from radiocore_tpu_torch.kernels.extract import extract_rows_plain
    group = min(group, c)
    spec = _spectrum(n, seed=c + m)
    s_norm = 1.0 / n
    got, launches = emulate_extract(spec.astype(np.complex128), a0, c, m, n,
                                    s_norm, group, lanes)
    assert launches == 2 * -(-c // group)
    want = extract_rows_plain(torch.from_numpy(spec.astype(np.complex128)),
                              a0, c, m, s_norm).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)
    if n & (n - 1) == 0:
        jax_out = np.asarray(extract_rows_pallas(jnp.asarray(spec), a0, c, m,
                                                 s_norm))
        np.testing.assert_allclose(got, jax_out, atol=ATOL)


@pytest.mark.parametrize("l2_mib,m,buffers,c,lanes,want", [
    (50, 1 << 18, 1, 64, 2, 8),     # an H100's 50 MB: 2 lanes of 16 MB
    (50, 1 << 18, 2, 96, 2, 4),     # SPEC's s and t
    (50, 1 << 18, 1, 64, 1, 16),    # one lane
    (50, 1 << 18, 1, 64, 4, 4),
    (50, 1 << 18, 1, 6, 2, 6),      # never more than the batch
    (40, 1 << 18, 1, 64, 2, 6),     # a smaller L2
    (4, 1 << 18, 2, 96, 2, 1),      # at least one station
    (50, 1 << 13, 1, 96, 2, 96),    # short stations: the whole batch
])
def test_group_size_from_l2(l2_mib, m, buffers, c, lanes, want):
    from radiocore_tpu_torch.kernels.extract import L2_SHARE, group_size
    g = group_size(l2_mib << 20, m, buffers, c, lanes)
    assert g == want
    num, den = L2_SHARE
    assert (num, den) == (2, 3)
    assert g == 1 or g * lanes * buffers * m * 8 * den <= (l2_mib << 20) * num

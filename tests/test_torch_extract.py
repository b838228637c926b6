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


# ---- K-GATHER: the reorder of any plan in one launch ---------------------

# (n, shifts, m): a uniform power-of-two plan (K-EXTRACT's on the card), a
# uniform plan of another m, non-uniform plans of an even and an odd m
# (the station at the centre wraps past bin n − 1), overlapping stations
# whose runs cross bin n − 1 at even and odd positions, an odd n, and
# C = 1 of each parity.
GATHER_PLANS = [
    (2048, tuple(-o for o in _uniform_plan(4, 512, 2048)), 512),
    (3000, tuple(-o for o in _uniform_plan(6, 500, 3000)), 500),
    (8192, (0, 1500, -2600, 3999), 512),
    (8192, (0, 1500, -2600, 3999), 513),
    (8192, (101, -250, 7, -8), 700),
    (8191, (0, 3, -4000, 4000), 701),
    (8192, (0,), 512),
    (8191, (1234,), 511),
]


@pytest.mark.parametrize("n,shifts,m", GATHER_PLANS)
def test_gather_plain_matches_reorder(n, shifts, m):
    """``extract_gather_plain`` (through the extractor's own starts,
    window and fix weight, the whole scale 1/n folded in) against the
    torch reorder and its scale, on the CPU; compared in the spectrum's
    units (times n), where ATOL is the file's bound."""
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.ops.channelize import (extraction_plan,
                                                    make_extractor)
    spec = torch.from_numpy(_spectrum(n, seed=m))
    ext = make_extractor(n, shifts, m)
    before = extract.gather_launches.count
    got = ext.gather(spec)
    want = ext.reorder(spec)
    assert extract.gather_launches.count == before
    assert got.shape == want.shape == (len(shifts), m)
    np.testing.assert_allclose(got.numpy() * np.float64(n),
                               want.numpy() * np.float64(n), atol=ATOL)
    # The same, straight from the plain version's arguments.
    starts, w_out, w_fix, _, _ = extraction_plan(n, shifts, m)
    fix = None if w_fix is None else float(w_fix) / n
    plain = extract.extract_gather_plain(
        spec, torch.tensor(starts, dtype=torch.int64),
        torch.from_numpy(w_out.astype(np.float64) / n).float(), fix)
    np.testing.assert_allclose(plain.numpy() * np.float64(n),
                               want.numpy() * np.float64(n), atol=ATOL)


def _parent_extract(spectrum, n, shifts, m, impl):
    """The CPU extraction as it was before K-GATHER (the reorder in
    torch, its divide, the route's inverse), the yardstick of
    'unchanged'."""
    from radiocore_tpu_torch.ops import fft as tfft
    from radiocore_tpu_torch.ops.channelize import (extraction_plan,
                                                    uniform_extraction_start)
    from radiocore_tpu_torch.runtime import Routes
    routes = Routes(extract_ifft=impl)
    starts, w_out, w_fix, m2, run = extraction_plan(n, shifts, m)
    neg, c, s_fac = m - m2, len(shifts), n / m
    w = torch.from_numpy(w_out)

    def reorder(sl):
        if m % 2 == 0:
            y = torch.cat([sl[..., m // 2:m + 1], sl[..., 1:m // 2]],
                          dim=-1) * w
            y[..., m2 - 1] += sl[..., 0] * float(w_fix)
        else:
            y = torch.cat([sl[..., neg:m], sl[..., :neg]], dim=-1) * w
        return y

    a0 = uniform_extraction_start(n, shifts, m)
    if a0 is not None:
        base = torch.cat([spectrum[..., a0:], spectrum[..., :a0],
                          spectrum[..., a0:a0 + 1]], dim=-1)[..., :c * m + 1]
        rows = base[..., :c * m].reshape(spectrum.shape[:-1] + (c, m))
        nxt = torch.cat([rows[..., 1:, :1], base[..., -1:].unsqueeze(-2)],
                        dim=-2)
        y = reorder(torch.cat([rows, nxt], dim=-1))
    else:
        ext = torch.cat([spectrum, spectrum[..., :run]], dim=-1)
        y = torch.stack([reorder(ext[..., s:s + run]) for s in starts],
                        dim=-2)
    if impl == "fourstep":
        return tfft.ifft_decomposed(y / s_fac, routes)
    return tfft.ifft(y / s_fac, routes)


@pytest.mark.parametrize("impl", ["auto", "native", "fourstep"])
@pytest.mark.parametrize("n,shifts,m,batch", [
    (2048, tuple(-o for o in _uniform_plan(4, 512, 2048)), 512, ()),
    (3000, tuple(-o for o in _uniform_plan(6, 500, 3000)), 500, ()),
    (8192, (0, 1500, -2600, 3999), 512, ()),
    (8192, (0, 1500, -2600, 3999), 513, (2,)),
    (8191, (1234,), 511, ()),
])
def test_cpu_extractor_unchanged(n, shifts, m, batch, impl):
    """On the CPU, ``make_extractor`` under ``auto``, ``native`` and
    ``fourstep`` gives what it gave before K-GATHER, bit for bit, and
    launches nothing."""
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.ops.channelize import make_extractor
    from radiocore_tpu_torch.runtime import Routes
    spec = torch.from_numpy(np.stack(
        [_spectrum(n, seed=m + i) for i in range(int(np.prod(batch)))]
    ).reshape(batch + (n,)))
    before = extract.gather_launches.count
    got = make_extractor(n, shifts, m, Routes(extract_ifft=impl))(spec)
    assert extract.gather_launches.count == before
    assert torch.equal(got, _parent_extract(spec, n, shifts, m, impl))


def gather_model(spec, starts, win, fix, m):
    """numpy model of csrc/extract_gather.cu over a spectrum (batch, n)
    whose base is 16-byte aligned: the (blocks, rows) grid, each thread's
    pairs at even flat output positions, the 16-byte load where the
    kernel takes one (checked to hold the two bins the pair needs),
    8-byte loads elsewhere, the fold of the fix bin and the store of each
    pair. Returns the output (batch, C, m), how many times each output
    was stored, and the number of 16-byte loads."""
    threads, per_thread = 256, 4
    batch, n = spec.shape
    c = len(starts)
    m2, lead = m // 2 + 1, 1 - m % 2
    neg = m - m2
    out = np.full(batch * c * m, np.nan, np.complex64)
    stored = np.zeros(batch * c * m, np.int64)
    wide = 0

    def run_bin(start, j):
        i = start + lead + (neg + j if j < m2 else j - m2)
        return i if i < n else i - n

    gx = -(-(m // 2 + 1) // (threads * per_thread))
    for row in range(batch * c):
        b, st = divmod(row, c)
        sp, start = spec[b], starts[st]
        vec = (b * n) % 2 == 0
        base = row * m
        lag = base & 1
        pairs = (m + 1 + lag) >> 1
        for bx in range(gx):
            for u in range(per_thread):
                for t in range(threads):
                    k = bx * threads * per_thread + u * threads + t
                    if k >= pairs:
                        continue
                    j = 2 * k - lag
                    has_lo, has_hi = j >= 0, j + 1 < m
                    lo = hi = np.complex64(0)
                    if has_lo and has_hi and j + 1 != m2:
                        i = run_bin(start, j)
                        if vec and i % 2 == 0 and i + 1 < n:
                            assert run_bin(start, j + 1) == i + 1
                            lo, hi = sp[i], sp[i + 1]
                            wide += 1
                        else:
                            assert run_bin(start, j + 1) == (i + 1) % n
                            lo, hi = sp[i], sp[(i + 1) % n]
                    else:
                        if has_lo:
                            lo = sp[run_bin(start, j)]
                        if has_hi:
                            hi = sp[run_bin(start, j + 1)]
                    a = lo * np.float32(win[j]) if has_lo else None
                    h = hi * np.float32(win[j + 1]) if has_hi else None
                    if lead and j == m2 - 1:
                        a = a + sp[start] * np.float32(fix)
                    if lead and j + 1 == m2 - 1:
                        h = h + sp[start] * np.float32(fix)
                    if has_lo and has_hi:
                        assert (base + j) % 2 == 0   # one 16-byte store
                    if has_lo:
                        out[base + j] = a
                        stored[base + j] += 1
                    if has_hi:
                        out[base + j + 1] = h
                        stored[base + j + 1] += 1
    return out.reshape(batch, c, m), stored, wide


@pytest.mark.parametrize("n,shifts,m,batch", [
    (8192, (0, 1500, -2600, 3999), 512, 1),   # even starts: wide loads
    (8192, (1, 1501, -2601, 3999), 512, 1),   # odd starts: narrow loads
    (8192, (101, -250, 7, -8), 700, 1),        # wraps at odd and even bins
    (8192, (0, 1500, -2600), 513, 2),          # odd flat row bases
    (8191, (0, 3, -4000), 701, 2),             # row 2 of the spectrum odd
    (4096, (0,), 2048, 1),                     # one station, two blocks
])
def test_gather_kernel_model(n, shifts, m, batch):
    """The kernel's index map, modelled in numpy, against the plain
    version: every output stored once, each pair's bins right."""
    from radiocore_tpu_torch.kernels.extract import extract_gather_plain
    from radiocore_tpu_torch.ops.channelize import extraction_plan
    starts, w_out, w_fix, _, _ = extraction_plan(n, shifts, m)
    win = (w_out.astype(np.float64) / n).astype(np.float32)
    fix = None if w_fix is None else float(np.float32(np.float64(w_fix) / n))
    spec = np.stack([_spectrum(n, seed=s) for s in range(batch)])
    got, stored, wide = gather_model(spec, starts, win, fix, m)
    assert (stored == 1).all()
    if all(s % 2 == 0 for s in starts) and m % 2 == 0 and n % 2 == 0:
        assert wide >= len(starts) * (m // 2 - 2)
    if all(s % 2 for s in starts) and m % 2 == 0:
        assert wide == 0
    want = extract_gather_plain(torch.from_numpy(spec),
                                torch.tensor(starts, dtype=torch.int64),
                                torch.from_numpy(win), fix).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n,m,fix,ok", [
    (1024, 1024, 0.5, False),    # the even run needs m + 1 bins
    (1024, 1023, None, True),
    (1024, 1023, 0.5, False),    # an odd m takes no fix weight
    (1024, 1022, None, False),   # an even m needs one
    (1024, 1022, 0.5, True),
])
def test_gather_rejects(n, m, fix, ok):
    from radiocore_tpu_torch.kernels.extract import extract_gather, gather_ok
    spec = torch.from_numpy(_spectrum(n))
    args = (spec, torch.zeros(2, dtype=torch.int64), torch.ones(m), fix)
    if ok:
        assert extract_gather(*args).shape == (2, m)
    else:
        with pytest.raises(ValueError):
            extract_gather(*args)
    assert gather_ok(n, m) == (m < n or m % 2 == 1)

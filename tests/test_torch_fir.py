"""K-FIR and the streaming FIR ops on the CPU: the plain K-FIR against
the JAX Pallas kernel (interpret mode), and the port's ``fir_causal`` /
``fir_stream`` / de-emphasis against the JAX ones."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

ATOL = 1e-5
SHAPE = (3, 49_152)


def _taps(t):
    if t == 51:
        from radiocore_tpu_torch.ops.design import deemphasis_taps
        return deemphasis_taps(49_152)
    from scipy import signal
    return signal.firwin(t, 0.45)


def _signal(seed, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    hist = rng.standard_normal(SHAPE[:-1] + (t - 1,)).astype(np.float32)
    return x, hist


@pytest.mark.parametrize("with_history", [True, False])
@pytest.mark.parametrize("t", [51, 129])
def test_plain_kernel_matches_pallas(t, with_history):
    from radiocore_tpu.kernels.fir_pallas import fir_causal_pallas
    from radiocore_tpu_torch.kernels.fir import fir_causal_rows
    taps = _taps(t)
    x, hist = _signal(t, t)
    h_j = jnp.asarray(hist) if with_history else None
    h_t = torch.from_numpy(hist) if with_history else None
    want = np.asarray(fir_causal_pallas(jnp.asarray(x), taps, history=h_j))
    got = fir_causal_rows(torch.from_numpy(x), taps, h_t).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("t", [51, 129])
def test_fir_stream_matches_jax(t):
    """Three chained chunks through both packages' fir_stream."""
    from radiocore_tpu.ops.fir import fir_stream as jax_stream
    from radiocore_tpu_torch.ops.fir import fir_stream
    taps = _taps(t)
    _, hist = _signal(7, t)
    h_j, h_t = jnp.asarray(hist), torch.from_numpy(hist)
    rng = np.random.default_rng(8)
    for _ in range(3):
        x = rng.standard_normal(SHAPE).astype(np.float32)
        want, h_j = jax_stream(jnp.asarray(x), taps, h_j)
        got, h_t = fir_stream(torch.from_numpy(x), taps, h_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))


def test_fir_causal_short_and_complex_match_jax():
    from radiocore_tpu.ops.fir import fir_causal as jax_fir
    from radiocore_tpu_torch.ops.fir import fir_causal
    taps = _taps(51)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 4000))
         + 1j * rng.standard_normal((2, 4000))).astype(np.complex64)
    want = np.asarray(jax_fir(jnp.asarray(x), taps))
    got = fir_causal(torch.from_numpy(x), taps).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_deemphasis_matches_jax():
    from radiocore_tpu.ops import deemphasis as jd
    from radiocore_tpu_torch.ops import deemphasis as td
    taps_j, hist_j = jd.deemphasis_init(49_152, batch_shape=(3,))
    taps_t, hist_t = td.deemphasis_init(49_152, batch_shape=(3,),
                                        device="cpu")
    np.testing.assert_array_equal(taps_t, taps_j)
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_j))
    x = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    want, _ = jd.deemphasis_apply(jnp.asarray(x), taps_j, hist_j)
    got, _ = td.deemphasis_apply(torch.from_numpy(x), taps_t, hist_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_kernel_route_needs_cuda():
    """A non-CPU, non-CUDA tensor raises instead of falling back."""
    from radiocore_tpu_torch.kernels.fir import fir_causal_rows
    with pytest.raises(ValueError):
        fir_causal_rows(torch.empty(SHAPE, device="meta"), _taps(51))


def fir_kernel_model(x, taps, hist=None, y_aligned=True):
    """numpy model of csrc/fir.cu's index map, block by block and thread by
    thread: the staged tile (halo of whole tap chunks first, 16-byte loads
    where the row's base is 16-byte aligned and the run lies inside the
    row, samples one by one elsewhere), its skewed layout, the window of
    ``OUTPUTS_PER_THREAD/TAP_CHUNK + 1`` register blocks that rotates one
    place per chunk of taps, and the staged store. ``x`` is a 2-D float
    view with unit stride along its last axis (any row stride); sums are
    float64, so only the indices are under test. Returns ``y`` and how
    many 16-byte and one-by-one fills the blocks made."""
    from radiocore_tpu_torch.kernels import fir
    R, C, threads, tile = (fir.OUTPUTS_PER_THREAD, fir.TAP_CHUNK,
                           fir.THREADS, fir.TILE)
    places = R // C + 1
    rows, n = x.shape
    T = len(taps)
    nq = fir.staged_chunks(T)
    H = nq * C
    assert H >= T - 1 and H % 4 == 0
    tp = np.zeros(H)
    tp[:T] = taps
    y = np.full((rows, n), np.nan)
    fills = {"vector": 0, "scalar": 0}
    tid = np.arange(threads)

    def sample(row, p):
        if p >= n:
            return 0.0
        if p >= 0:
            return x[row, p]
        return hist[row, T - 1 + p] if hist is not None and p >= -(T - 1) \
            else 0.0

    for row in range(rows):
        vec = x[row].ctypes.data % 16 == 0
        for tile0 in range(0, n, tile):
            xs = np.full(fir.skew(H + tile) + 4, np.nan)
            for v in range((H + tile) // 4):
                p = tile0 - H + 4 * v
                if vec and p >= 0 and p + 3 < n:
                    xs[fir.skew(4 * v):fir.skew(4 * v) + 4] = x[row, p:p + 4]
                    fills["vector"] += 1
                else:
                    xs[fir.skew(4 * v):fir.skew(4 * v) + 4] = [
                        sample(row, p + e) for e in range(4)]
                    fills["scalar"] += 1
            assert fir.skew(H + tile) * 4 + 4 * H == fir.smem_bytes(T)
            # All threads at once; a block of the window is C samples at
            # a multiple of C, so it never crosses the skew's padding.
            u0 = H + tid * R
            w = np.full((places, threads, C), np.nan)

            def block(u):
                pos = np.array([fir.skew(int(s)) for s in u])
                assert np.all(pos % 4 == 0)
                return xs[pos[:, None] + np.arange(C)]

            for b in range(R // C):
                w[b + 1] = block(u0 + b * C)
            acc = np.zeros((threads, R))
            for q in range(nq):
                ph = q % places
                u = u0 - q * C
                w[(places - ph) % places] = block(u - C)
                for c in range(C):
                    for j in range(R):
                        b, o = divmod(j - c, C)          # floor division
                        acc[:, j] += tp[q * C + c] * w[(b + 1 - ph) % places,
                                                       :, o]
            # The staged store: outputs back at the tile's place, then 16
            # bytes a thread in the order of the fill.
            for th in range(threads):
                for j in range(R):
                    xs[fir.skew(th * R + j)] = acc[th, j]
            left = n - tile0
            for i in range(R // 4):
                for th in range(threads):
                    o = 4 * (th + i * threads)
                    if o >= left:
                        continue
                    val = xs[fir.skew(o):fir.skew(o) + 4]
                    if y_aligned and n % 4 == 0 and o + 3 < left:
                        y[row, tile0 + o:tile0 + o + 4] = val
                    else:
                        for e in range(min(4, left - o)):
                            y[row, tile0 + o + e] = val[e]
    return y, fills


@pytest.mark.parametrize("with_history", [True, False])
@pytest.mark.parametrize("t", [1, 2, 51, 129, 300, 4096])
def test_kernel_index_map_emulated(t, with_history):
    """The kernel's tile, halo, register window, chunked tap loop and load
    choice, modelled in numpy, against ``np.convolve`` in float64: a length
    that is no multiple of the tile or of 4, rows that are one leg of a
    (rows, 2, n) array (a strided view whose rows alternate between
    16-byte aligned and not), with and without history."""
    from radiocore_tpu_torch.kernels import fir
    rng = np.random.default_rng(t)
    n = fir.TILE + 1001
    rows = 3
    taps = rng.standard_normal(t) / np.sqrt(t)
    # An aligned base and an odd row length: row r of leg 0 starts 2·r·n
    # floats in, so every other row is off a 16-byte boundary.
    raw = np.zeros(rows * 2 * n + 4, np.float32)
    off = (-raw.ctypes.data // 4) % 4
    both = raw[off:off + rows * 2 * n].reshape(rows, 2, n)
    both[...] = rng.standard_normal(both.shape)
    x = both[:, 0, :]
    assert x.strides == (8 * n, 4)
    assert len({x[r].ctypes.data % 16 == 0 for r in range(rows)}) == 2
    hist = rng.standard_normal((rows, t - 1)).astype(np.float32) \
        if with_history and t > 1 else None
    got, fills = fir_kernel_model(x, taps, hist)
    assert fills["vector"] > 0 and fills["scalar"] > 0
    for r in range(rows):
        before = hist[r] if hist is not None else np.zeros(t - 1)
        full = np.concatenate([before, x[r]]).astype(np.float64)
        want = np.convolve(full, taps)[t - 1:t - 1 + n]
        np.testing.assert_allclose(got[r], want, atol=ATOL)


def test_kernel_model_matches_plain_and_pallas():
    """The modelled kernel at the de-emphasis taps against the port's
    plain version and the JAX Pallas kernel (interpret mode)."""
    from radiocore_tpu.kernels.fir_pallas import fir_causal_pallas
    from radiocore_tpu_torch.kernels import fir
    taps = _taps(51)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 2 * fir.TILE + 16_384 - 4096)).astype(
        np.float32)
    hist = rng.standard_normal((2, 50)).astype(np.float32)
    got, fills = fir_kernel_model(x, taps, hist)
    plain = fir.fir_causal_plain(torch.from_numpy(x), taps,
                                 torch.from_numpy(hist)).numpy()
    want = np.asarray(fir_causal_pallas(jnp.asarray(x), taps,
                                        history=jnp.asarray(hist)))
    np.testing.assert_allclose(got, plain, atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_kernel_geometry():
    """The constants the model shares with csrc/fir.cu, the skew's bank
    property (the 16-byte loads of 8 neighbouring threads fall on 8
    distinct 16-byte bank groups, wherever the window stands) and the
    shared memory of the longest tap set within an SM's."""
    from radiocore_tpu_torch.kernels import fir
    assert (fir.OUTPUTS_PER_THREAD, fir.TAP_CHUNK, fir.THREADS,
            fir.TILE) == (8, 8, 256, 2048)
    assert fir.staged_chunks(51) == 7 and fir.staged_chunks(129) == 17
    assert fir.staged_chunks(1) == 1 and fir.staged_chunks(4096) == 512
    for start in range(0, 64, 4):
        for first in range(0, 32, 8):
            groups = {(fir.skew(start + fir.OUTPUTS_PER_THREAD * lane) // 4)
                      % 8 for lane in range(first, first + 8)}
            if start % fir.TAP_CHUNK == 0:
                assert len(groups) == 8, (start, first)
    assert fir.smem_bytes(51) < 16 * 1024
    assert 8 * (fir.smem_bytes(51) + 1024) <= 227 * 1024   # 8 blocks an SM
    assert fir.smem_bytes(fir.MAX_TAPS) <= 227 * 1024

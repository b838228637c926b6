"""The port's feedback NCO loop (ops/nco_pll.py, kernels/nco_pll.py): the
cells of tests/test_nco_pll.py on the port, its trajectory and carried
state against the JAX scan (modulo 2π: two correct float32 runs may wrap
one sample apart), and the NumPy model of the kernel's arithmetic and
tile walk."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiocore_tpu_torch.kernels import nco_pll as knco

torch.set_num_threads(2)

FS = 100_000
RAD = 1e-4   # trajectory and phase against the JAX scan, modulo 2π


def _pilot(n, f=19e3, phi0=0.5, fs=FS):
    t = np.arange(n) / fs
    theta = 2 * np.pi * f * t + phi0
    return np.sin(theta).astype(np.float32), theta


def _wrapped(a, b):
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64) + np.pi) % (
        2 * np.pi) - np.pi
    return np.abs(d)


def _port():
    from radiocore_tpu_torch.ops import nco_pll
    return nco_pll


def _track(pilot, gains, state=None):
    npl = _port()
    x = torch.from_numpy(np.asarray(pilot))
    if state is None:
        state = npl.pll_init(tuple(x.shape[:-1]), device="cpu")
    return npl.nco_pll_track(x, gains, state)


def test_pll_design_and_init_match_jax():
    from radiocore_tpu.ops import nco_pll as jn
    npl = _port()
    for args in ((FS,), (262_144, 19e3, 50.0), (FS, 19e3, 100.0, 1.0)):
        assert tuple(npl.pll_design(*args)) == tuple(jn.pll_design(*args))
    state = npl.pll_init((3, 2), device="cpu")
    assert state._fields == jn.pll_init((3, 2))._fields
    assert all(tuple(s.shape) == (3, 2) and s.dtype == torch.float32
               and not bool(s.any()) for s in state)


def test_locks_and_regenerates_subcarrier():
    npl = _port()
    pilot, theta = _pilot(FS, f=19_003.0)   # 3 Hz off nominal
    gains = npl.pll_design(FS, 19e3, loop_bw_hz=100.0)
    traj, state = _track(pilot, gains)
    sub = npl.pll_subcarrier(traj, 2, "imag").numpy()
    want = -np.sin(2 * theta)
    settle = 20_000
    err = np.sqrt(np.mean((sub[settle:] - want[settle:]) ** 2))
    assert err < 0.05, err
    assert abs(float(state.freq) * FS / (2 * np.pi) - 3.0) < 1.0


def test_streaming_matches_one_shot():
    npl = _port()
    n = FS // 2
    pilot, _ = _pilot(2 * n)
    gains = npl.pll_design(FS, 19e3)
    whole, end = _track(pilot, gains)
    state, parts = None, []
    for i in range(2):
        traj, state = _track(pilot[i * n:(i + 1) * n], gains, state)
        parts.append(traj.numpy())
    # The same float32 operations in the same order: bit equal.
    np.testing.assert_array_equal(np.concatenate(parts), whole.numpy())
    assert float(state.phase) == float(end.phase)
    assert float(state.freq) == float(end.freq)


def test_parity_with_analytic_path():
    """Once locked, the feedback loop's subcarrier matches the
    analytic-signal subcarrier (the demodulator contract)."""
    npl = _port()
    from radiocore_tpu_torch.ops.analytic import (analytic_signal,
                                                  pll_harmonic)
    pilot, _ = _pilot(FS)
    gains = npl.pll_design(FS, 19e3, loop_bw_hz=100.0)
    traj, _ = _track(pilot, gains)
    sub_fb = npl.pll_subcarrier(traj, 2, "imag").numpy()
    sub_an = pll_harmonic(analytic_signal(torch.from_numpy(pilot)), 2,
                          "imag").numpy()
    settle = 20_000
    err = np.sqrt(np.mean((sub_fb[settle:-100] - sub_an[settle:-100]) ** 2))
    assert err < 0.05, err


def test_batched_matches_the_jax_scan_modulo_two_pi():
    """Trajectory and carried state of a (2, 2) batch over two chained
    chunks against the JAX scan: ≤ 1e-4 rad modulo 2π, the frequency
    state within 1e-7 rad/sample."""
    from radiocore_tpu.ops import nco_pll as jn
    npl = _port()
    n = FS // 4
    rng = np.random.default_rng(9)
    pilots = np.stack([_pilot(2 * n, f, p)[0] for f, p in
                       ((19e3, 0.5), (19_002.0, 1.2), (18_998.5, -2.0),
                        (19e3, 3.0))]).reshape(2, 2, 2 * n)
    pilots = (np.sqrt(2.0) * pilots
              + 0.1 * rng.standard_normal(pilots.shape)).astype(np.float32)
    gains = npl.pll_design(FS, 19e3)
    st_j = jn.pll_init((2, 2))
    st_t = npl.pll_init((2, 2), device="cpu")
    for i in range(2):
        chunk = pilots[..., i * n:(i + 1) * n]
        want, st_j = jn.nco_pll_track(jnp.asarray(chunk), gains, st_j)
        got, st_t = npl.nco_pll_track(torch.from_numpy(chunk), gains, st_t)
        assert tuple(got.shape) == (2, 2, n)
        assert _wrapped(got.numpy(), want).max() <= RAD
        assert _wrapped(st_t.phase.numpy(), st_j.phase).max() <= RAD
        np.testing.assert_allclose(st_t.freq.numpy(), np.asarray(st_j.freq),
                                   atol=1e-7)
    solo, _ = _track(pilots[1, 0, :n], gains)
    first, _ = _track(pilots[..., :n], gains)
    np.testing.assert_array_equal(first[1, 0].numpy(), solo.numpy())


@pytest.mark.parametrize("part", ["imag", "real"])
def test_pll_subcarrier_matches_jax(part):
    from radiocore_tpu.ops import nco_pll as jn
    npl = _port()
    traj = np.random.default_rng(2).uniform(-np.pi, np.pi, (3, 500)).astype(
        np.float32)
    np.testing.assert_allclose(
        npl.pll_subcarrier(torch.from_numpy(traj), 2, part).numpy(),
        np.asarray(jn.pll_subcarrier(jnp.asarray(traj), 2, part)), atol=1e-6)


def tile_walk(n: int, aligned: bool):
    """The order in which the kernel's thread visits the samples of its
    row: ``(tiles, tail)`` where ``tiles`` are the ``(first, last + 1)``
    spans it takes by 16-byte accesses (each loaded one tile ahead) and
    ``tail`` the span it takes sample by sample. Rows off a 16-byte
    boundary (``aligned`` false) are all tail."""
    full = n // knco.TILE if aligned else 0
    return ([(i * knco.TILE, (i + 1) * knco.TILE) for i in range(full)],
            (full * knco.TILE, n))


def nco_kernel_model(pilot: np.ndarray, kp: float, ki: float, w0: float,
                     phase: np.ndarray, freq: np.ndarray,
                     aligned: bool = True):
    """NumPy model of ``csrc/nco_pll.cu``: float32 round-to-nearest operations in
    the kernel's order (no FMA), rows as the vector, the samples visited
    as :func:`tile_walk` says, each tile read whole before its first
    sample is worked."""
    f32 = np.float32
    x = np.asarray(pilot, f32)
    n = x.shape[-1]
    phase = np.array(phase, f32)
    freq = np.array(freq, f32)
    traj = np.full(x.shape, np.nan, f32)
    kp, ki, w0 = f32(kp), f32(ki), f32(w0)
    pi, two_pi = f32(np.pi), f32(2 * np.pi)

    def sample(xt, t):
        nonlocal phase, freq
        traj[..., t] = phase
        err = xt * np.cos(phase, dtype=f32)
        freq = freq + ki * err
        phase = ((phase + w0) + freq) + kp * err
        phase = np.where(phase > pi, phase - two_pi, phase).astype(f32)

    tiles, (t0, t1) = tile_walk(n, aligned)
    for a, b in tiles:
        tile = x[..., a:b].copy()
        for j in range(b - a):
            sample(tile[..., j], a + j)
    for t in range(t0, t1):
        sample(x[..., t], t)
    return traj, phase, freq


@pytest.mark.parametrize("n,aligned", [(4096, True), (4099, True),
                                       (4097, False), (7, True), (16, True)])
def test_kernel_model_walks_every_sample_once(n, aligned):
    """The tile walk of the kernel (16-sample tiles by 16-byte accesses,
    a scalar tail; all tail for rows off a 16-byte boundary) covers the
    row once, in order, and the model built on it is the plain loop bit
    for bit."""
    tiles, tail = tile_walk(n, aligned)
    spans = tiles + [tail]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(b - a == knco.TILE and a % 4 == 0 for a, b in tiles)
    assert (len(tiles) == n // knco.TILE) if aligned else not tiles

    rng = np.random.default_rng(n)
    rows = 3
    x = (np.sqrt(2.0) * np.stack([_pilot(n, 19e3 + d, p, fs=262_144)[0]
                                  for d, p in ((0, 0.1), (2, 1.0), (-1, 2.5))])
         + 0.1 * rng.standard_normal((rows, n))).astype(np.float32)
    phase0 = rng.uniform(-1, 1, rows).astype(np.float32)
    freq0 = (1e-5 * rng.standard_normal(rows)).astype(np.float32)
    gains = _port().pll_design(262_144, 19e3)
    traj, phase, freq = nco_kernel_model(x, *gains, phase0, freq0,
                                         aligned=aligned)
    assert not np.isnan(traj).any()
    want = knco.nco_pll_track_plain(torch.from_numpy(x), *gains,
                                    torch.from_numpy(phase0),
                                    torch.from_numpy(freq0))
    # The model's float32 cos is NumPy's, the plain loop's is torch's:
    # equal but for a last bit here and there, which the loop holds down.
    assert _wrapped(traj, want[0].numpy()).max() <= 1e-5
    assert _wrapped(phase, want[1].numpy()).max() <= 1e-5
    np.testing.assert_allclose(freq, want[2].numpy(), atol=1e-8)


def test_wrapper_checks_and_counts_nothing_on_the_cpu():
    """A CPU tensor runs the plain loop and counts no launch; the state
    it is given is left as it was."""
    npl = _port()
    pilot, _ = _pilot(2000)
    state = npl.pll_init((), device="cpu")
    before = knco.launches.count
    _, new = npl.nco_pll_track(torch.from_numpy(pilot),
                               npl.pll_design(FS), state)
    assert knco.launches.count == before
    assert float(state.phase) == 0.0 and float(new.phase) != 0.0

"""The port's feedback NCO loop (ops/nco_pll.py, kernels/nco_pll.py): the
cells of tests/test_nco_pll.py on the port, its trajectory and carried
state against the JAX scan (modulo 2π: two correct float32 runs may wrap
one sample apart), and the NumPy model of the kernel's substituted
arithmetic, its guard and its tile walk."""

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
    row: ``(tiles, tail, width)`` where ``tiles`` are the ``(first,
    last + 1)`` spans it takes a tile at a time, each loaded one tile
    ahead, ``tail`` the ragged end it takes sample by sample, and
    ``width`` the floats of one access: 4 (16-byte accesses) for rows on
    a 16-byte boundary (``aligned``), else 1."""
    full = n // knco.TILE
    return ([(i * knco.TILE, (i + 1) * knco.TILE) for i in range(full)],
            (full * knco.TILE, n), 4 if aligned else 1)


def hw_cos_model(p: np.ndarray) -> np.ndarray:
    """``__cosf`` as the card computes it: ``p`` scaled by 1/2π in
    float32, rounded toward zero (FMUL.RZ), then the cosine of those
    revolutions (MUFU.COS), here rounded once from float64; the unit's
    own error, within 2^-21.41 on [−π, π], is not modelled."""
    f32, f64 = np.float32, np.float64
    exact = p.astype(f64) * f64(f32(1 / (2 * np.pi)))
    rev = exact.astype(f32)
    rev = np.where(np.abs(rev.astype(f64)) > np.abs(exact),
                   np.nextafter(rev, f32(0)), rev)
    return np.cos(2 * np.pi * rev.astype(f64)).astype(f32)


def _fma(a, b, c):
    """float32 fused multiply-add: the product exact in float64, the sum
    rounded to float32 (once more to float64 first, which moves no
    result of this loop)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def nco_kernel_model(pilot: np.ndarray, kp: float, ki: float, w0: float,
                     phase: np.ndarray, freq: np.ndarray,
                     aligned: bool = True):
    """NumPy model of ``csrc/nco_pll.cu`` (``nco_sample``), rows as the
    vector, ``p`` the phase before its wrap::

        seen = wrap(p);  s = (seen + w0) + f;  a = kk·x;  b = ki·x
        c = cos(p) by the guard;  p = fma(a, c, s);  f = fma(b, c, f)

    (``kk`` = ki + kp in float32), the samples visited as
    :func:`tile_walk` says, each tile read whole before its first sample
    is worked. The guard: ``|p| > 2π`` takes the float32 cosine of ``p``,
    else :func:`hw_cos_model` (the kernel works a tile on the hardware
    cosine and works it again with the guard if one of its samples met
    such a phase, which gives the same). Returns ``(traj, phase, freq,
    guarded)``, ``guarded`` the samples of each row that took the
    guard."""
    f32 = np.float32
    x = np.asarray(pilot, f32)
    n = x.shape[-1]
    p = np.array(phase, f32)
    f = np.array(freq, f32)
    traj = np.full(x.shape, np.nan, f32)
    guarded = np.zeros(x.shape[:-1], np.int64)
    kp, ki, w0 = f32(kp), f32(ki), f32(w0)
    kk = ki + kp
    pi, two_pi = f32(np.pi), f32(2 * np.pi)

    def wrap(v):
        return np.where(v > pi, v - two_pi, v).astype(f32)

    def sample(xt, t):
        nonlocal p, f, guarded
        seen = wrap(p)
        traj[..., t] = seen
        a, b = kk * xt, ki * xt
        s = (seen + w0) + f
        far = np.abs(p) > two_pi
        guarded = guarded + far
        c = np.where(far, np.cos(p, dtype=f32), hw_cos_model(p))
        p, f = _fma(a, c, s), _fma(b, c, f)

    tiles, (t0, t1), _ = tile_walk(n, aligned)
    for a, b in tiles:
        tile = x[..., a:b].copy()
        for j in range(b - a):
            sample(tile[..., j], a + j)
    for t in range(t0, t1):
        sample(x[..., t], t)
    return traj, wrap(p), f, guarded


# The kernel against the plain loop (scan order), modulo 2π: two float32
# loops that round differently drift apart by about 1e-5 rad before the
# loop's feedback pulls them back; chip_smoke.py NCO_PLAIN_MAX.
PLAIN_RAD = 5e-5


def _pilots(n, rows, seed, phi0=None):
    """``rows`` rms-normalised 19 kHz pilots at 262 144 S/s with offsets
    of a few Hz, start phases ``phi0`` (default: seeded) and noise at 0.1
    of the rms; float32."""
    rng = np.random.default_rng(seed)
    if phi0 is None:
        phi0 = rng.uniform(0, 2 * np.pi, rows)
    t = np.arange(n) / 262_144
    df = rng.uniform(-3, 3, rows)
    x = np.sqrt(2.0) * np.sin(2 * np.pi * (19e3 + df[:, None]) * t
                              + np.asarray(phi0)[:, None])
    return (x + 0.1 * rng.standard_normal((rows, n))).astype(np.float32)


def _plain(x, gains, phase0, freq0):
    return [v.numpy() for v in knco.nco_pll_track_plain(
        torch.from_numpy(x), *gains, torch.from_numpy(phase0),
        torch.from_numpy(freq0))]


def _jax(x, gains, phase0, freq0):
    from radiocore_tpu.ops import nco_pll as jn
    traj, st = jn.nco_pll_track(jnp.asarray(x), gains,
                                jn.PLLState(jnp.asarray(phase0),
                                            jnp.asarray(freq0)))
    return [np.asarray(v) for v in (traj, st.phase, st.freq)]


@pytest.mark.parametrize("n,aligned", [(4096, True), (4099, True),
                                       (4097, False), (7, True), (16, True)])
def test_kernel_model_walks_every_sample_once(n, aligned):
    """The tile walk of the kernel (48-sample tiles, by 16-byte accesses
    on a 16-byte boundary and by scalar ones off it, a scalar tail)
    covers the row once, in order, and the model built on it stays
    within PLAIN_RAD of the plain loop and within RAD of the JAX scan,
    modulo 2π, its final frequency within 1e-8 of the plain loop's."""
    tiles, tail, width = tile_walk(n, aligned)
    spans = tiles + [tail]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(b - a == knco.TILE and a % 4 == 0 for a, b in tiles)
    assert len(tiles) == n // knco.TILE and tail[1] - tail[0] < knco.TILE
    assert width == (4 if aligned else 1)

    rng = np.random.default_rng(n)
    rows = 3
    x = (np.sqrt(2.0) * np.stack([_pilot(n, 19e3 + d, p, fs=262_144)[0]
                                  for d, p in ((0, 0.1), (2, 1.0), (-1, 2.5))])
         + 0.1 * rng.standard_normal((rows, n))).astype(np.float32)
    phase0 = rng.uniform(-1, 1, rows).astype(np.float32)
    freq0 = (1e-5 * rng.standard_normal(rows)).astype(np.float32)
    gains = _port().pll_design(262_144, 19e3)
    traj, phase, freq, guarded = nco_kernel_model(x, *gains, phase0, freq0,
                                                  aligned=aligned)
    assert not np.isnan(traj).any() and not guarded.any()
    want = _plain(x, gains, phase0, freq0)
    assert _wrapped(traj, want[0]).max() <= PLAIN_RAD
    assert _wrapped(phase, want[1]).max() <= PLAIN_RAD
    np.testing.assert_allclose(freq, want[2], atol=1e-8)
    scan = _jax(x, gains, phase0, freq0)
    assert _wrapped(traj, scan[0]).max() <= RAD
    assert _wrapped(phase, scan[1]).max() <= RAD
    np.testing.assert_allclose(freq, scan[2], atol=1e-7)


def test_substituted_order_equals_the_scan_in_float64():
    """One sample of the kernel's order (the frequency update put into
    the phase update, the cosine of the unwrapped phase) against one
    sample of the scan, in float64 on random states: the same phase the
    detector saw, the same next phase after its wrap, the same
    frequency, to 1e-12."""
    rng = np.random.default_rng(5)
    m = 10_000
    kp, ki, w0 = _port().pll_design(262_144, 19e3, 50.0)
    p = rng.uniform(-np.pi, np.pi + 0.6, m)      # before the wrap
    f = 1e-4 * rng.standard_normal(m)
    x = 2.0 * rng.standard_normal(m)

    def wrap(v):
        return np.where(v > np.pi, v - 2 * np.pi, v)

    phi = wrap(p)                                 # the scan's phase
    err = x * np.cos(phi)
    f_scan = f + ki * err
    phi_scan = wrap(phi + w0 + f_scan + kp * err)

    c = np.cos(p)
    p_next = (wrap(p) + w0) + f + (ki + kp) * x * c
    f_next = f + ki * x * c
    np.testing.assert_allclose(wrap(p_next), phi_scan, atol=1e-12, rtol=0)
    np.testing.assert_allclose(f_next, f_scan, atol=1e-12, rtol=0)
    assert (p_next > np.pi).any()     # the next wrap is left to the next
    #                                   sample, as in the kernel


def test_nan_row_stays_nan():
    """A NaN pilot row, as a dead ``exact`` channel gives: its
    trajectory is NaN from the second sample on (the first is the phase
    it was given), its state NaN, in the kernel's model, the plain loop
    and the JAX scan alike; the other rows are what they are without
    it."""
    n, rows, dead = 512, 3, 1
    x = _pilots(n, rows, 11)
    gains = _port().pll_design(262_144, 19e3)
    phase0 = np.array([0.3, -0.7, 1.1], np.float32)
    freq0 = np.zeros(rows, np.float32)
    x_dead = x.copy()
    x_dead[dead] = np.nan
    live = [r for r in range(rows) if r != dead]
    model = lambda v: nco_kernel_model(v, *gains, phase0, freq0)[:3]
    for run in (model, lambda v: _plain(v, gains, phase0, freq0),
                lambda v: _jax(v, gains, phase0, freq0)):
        traj, phase, freq = run(x_dead)
        clean = run(x)
        assert traj[dead, 0] == phase0[dead]
        assert np.isnan(traj[dead, 1:]).all()
        assert np.isnan(phase[dead]) and np.isnan(freq[dead])
        np.testing.assert_array_equal(traj[live], clean[0][live])
        np.testing.assert_array_equal(phase[live], clean[1][live])
        np.testing.assert_array_equal(freq[live], clean[2][live])


@pytest.mark.parametrize("wild", [50.0, -50.0])
def test_wild_initial_phase(wild):
    """An initial phase of ±50 rad (the pilot in step with it modulo 2π)
    sends the model's guard to the float32 cosine until the phase is
    back within 2π, and the row stays within PLAIN_RAD of the plain loop
    modulo 2π, its final frequency within 1e-8; a row started in range
    never takes the guard."""
    n = 2048
    phase0 = np.array([wild, 0.4], np.float32)
    x = _pilots(n, 2, 13, phi0=np.mod(phase0.astype(np.float64), 2 * np.pi))
    freq0 = np.zeros(2, np.float32)
    gains = _port().pll_design(262_144, 19e3)
    traj, phase, freq, guarded = nco_kernel_model(x, *gains, phase0, freq0)
    # +50 falls by 2π a sample (the wrap), -50 climbs by w0 a sample.
    steps = 8 if wild > 0 else int((abs(wild) - 2 * np.pi) / gains.w0) + 1
    assert abs(int(guarded[0]) - steps) <= 1 and guarded[1] == 0
    want = _plain(x, gains, phase0, freq0)
    assert _wrapped(traj, want[0]).max() <= PLAIN_RAD
    assert _wrapped(phase, want[1]).max() <= PLAIN_RAD
    np.testing.assert_allclose(freq, want[2], atol=1e-8)


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


def test_chain_probe_needs_the_card():
    """The latency probe is a measuring aid for the card: it has no plain
    version and refuses the CPU, an unknown chain and a lane count
    outside one warp before it builds anything."""
    gains = _port().pll_design(262_144)
    with pytest.raises(ValueError, match="times the card"):
        knco.nco_chain_probe(1024, "bare", 1, *gains, device="cpu")
    for chain, lanes in (("cosf", 1), ("bare", 0), ("bare", 33)):
        with pytest.raises(ValueError):
            knco.nco_chain_probe(1024, chain, lanes, *gains, device="cuda")


def test_sweep_variants_rewrite_the_constants():
    """``tools/nco_sweep`` rewrites the tile, the prefetch distance and
    the rows a block of ``csrc/nco_pll.cu`` and nothing else; its first
    variant is the source as shipped."""
    from radiocore_tpu_torch.kernels import build
    from radiocore_tpu_torch.tools import nco_sweep
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    assert nco_sweep.variant_source(src, *nco_sweep.VARIANTS[0]) == src
    assert f"kNcoTile = {knco.TILE};" in src
    out = nco_sweep.variant_source(src, 16, 0, 32)
    assert "kNcoTile = 16;" in out and "kNcoAhead = 1 << 30;" in out
    assert "rc::nco_lanes(rows, sms)" not in out
    assert "const int lanes = 32;" in out
    assert len(out.splitlines()) == len(src.splitlines())

"""The port's feedback NCO loop (ops/nco_pll.py, kernels/nco_pll.py): the
cells of tests/test_nco_pll.py on the port, its trajectory and carried
state against the JAX scan (modulo 2π: two correct float32 runs may wrap
one sample apart), and one sample of the kernel's phasor arithmetic
against one sample of the scan in float64."""

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


def _pilots(n, rows, seed):
    """``rows`` rms-normalised 19 kHz pilots at 262 144 S/s with offsets
    of a few Hz, seeded start phases and noise at 0.1 of the rms;
    float32."""
    rng = np.random.default_rng(seed)
    phi0 = rng.uniform(0, 2 * np.pi, rows)
    t = np.arange(n) / 262_144
    df = rng.uniform(-3, 3, rows)
    x = np.sqrt(2.0) * np.sin(2 * np.pi * (19e3 + df[:, None]) * t
                              + phi0[:, None])
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


def test_phasor_sample_equals_the_scan_in_float64():
    """One sample of the kernel's arithmetic (the NCO as w = √2·e^{jφ};
    ψ = f + (kp + ki)·x·Re w/√2, f' = f + ki·x·Re w/√2, w' = w·e^{jw0}·
    e^{jψ}) against one sample of the scan, in float64 on random states:
    the phase the detector saw, atan2(Im w, Re w), the next phase after
    its wrap (modulo 2π) and the frequency the same to 1e-12, the
    subcarrier −Re w·Im w the scan's −sin 2φ; and the series' form the
    kernel applies, (ur − ψ·(ui + h·ur), ui + ψ·(ur − h·ui)) with h =
    ψ/2, is u·(1 − ψ²/2 + jψ)."""
    rng = np.random.default_rng(5)
    m = 10_000
    kp, ki, w0 = _port().pll_design(262_144, 19e3, 50.0)
    phi = rng.uniform(-np.pi, np.pi, m)          # the scan's phase
    f = 1e-4 * rng.standard_normal(m)
    x = 2.0 * rng.standard_normal(m)

    err = x * np.cos(phi)
    f_scan = f + ki * err
    phi_scan = phi + w0 + f_scan + kp * err
    phi_scan = np.where(phi_scan > np.pi, phi_scan - 2 * np.pi, phi_scan)

    w = np.sqrt(2.0) * np.exp(1j * phi)
    psi = f + (kp + ki) * x * w.real / np.sqrt(2.0)
    f_next = f + ki * x * w.real / np.sqrt(2.0)
    u = w * np.exp(1j * w0)
    w_next = u * np.exp(1j * psi)
    np.testing.assert_allclose(np.arctan2(w.imag, w.real), phi, atol=1e-12,
                               rtol=0)
    assert _wrapped(np.arctan2(w_next.imag, w_next.real),
                    phi_scan).max() <= 1e-12
    np.testing.assert_allclose(f_next, f_scan, atol=1e-12, rtol=0)
    np.testing.assert_allclose(-w.real * w.imag, -np.sin(2 * phi),
                               atol=1e-12, rtol=0)
    h = psi / 2
    q = (u.real - psi * (u.imag + h * u.real)
         + 1j * (u.imag + psi * (u.real - h * u.imag)))
    np.testing.assert_allclose(q, u * (1 - psi ** 2 / 2 + 1j * psi),
                               atol=1e-12, rtol=0)


def test_nan_row_stays_nan():
    """A NaN pilot row, as a dead ``exact`` channel gives: its
    trajectory is NaN from the second sample on (the first is the phase
    it was given), its state NaN, in the kernel's plain loop (its phase
    output), the scan-order plain loop and the JAX scan alike; the other
    rows are what they are without it."""
    n, rows, dead = 512, 3, 1
    x = _pilots(n, rows, 11)
    gains = _port().pll_design(262_144, 19e3)
    phase0 = np.array([0.3, -0.7, 1.1], np.float32)
    freq0 = np.zeros(rows, np.float32)
    x_dead = x.copy()
    x_dead[dead] = np.nan
    live = [r for r in range(rows) if r != dead]
    def phasor(v):
        return [a.numpy() for a in knco.nco_pll_phasor_plain(
            torch.from_numpy(v), torch.ones(rows), *gains,
            torch.from_numpy(phase0), torch.from_numpy(freq0), "phase")]

    for run in (phasor, lambda v: _plain(v, gains, phase0, freq0),
                lambda v: _jax(v, gains, phase0, freq0)):
        traj, phase, freq = run(x_dead)
        clean = run(x)
        assert traj[dead, 0] == phase0[dead]
        assert np.isnan(traj[dead, 1:]).all()
        assert np.isnan(phase[dead]) and np.isnan(freq[dead])
        np.testing.assert_array_equal(traj[live], clean[0][live])
        np.testing.assert_array_equal(phase[live], clean[1][live])
        np.testing.assert_array_equal(freq[live], clean[2][live])


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
        knco.nco_chain_probe(1024, "phasor", 1, *gains, device="cpu")
    for chain, lanes in (("cosf", 1), ("phasor", 0), ("phasor", 33)):
        with pytest.raises(ValueError):
            knco.nco_chain_probe(1024, chain, lanes, *gains, device="cuda")


def test_sweep_variants_rewrite_the_constants():
    """``tools/nco_sweep`` rewrites the tile and the ring's depth of
    ``csrc/nco_pll.cu`` and nothing else; its first pair is the source as
    shipped, and a source without either constant raises."""
    from radiocore_tpu_torch.kernels import build
    from radiocore_tpu_torch.tools import nco_sweep
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    assert nco_sweep.variant_source(src, *nco_sweep.VARIANTS[0]) == src
    assert f"kNcoPhasorTile = {knco.PHASOR_TILE};" in src
    out = nco_sweep.variant_source(src, 16, 7)
    changed = [(a, b) for a, b in zip(src.splitlines(), out.splitlines())
               if a != b]
    assert len(out.splitlines()) == len(src.splitlines())
    assert len(changed) == 2
    assert "kNcoPhasorTile = 16;" in changed[0][1]
    assert "kNcoRing = 7;" in changed[1][1]
    assert len(set(nco_sweep.VARIANTS)) == len(nco_sweep.VARIANTS)
    for name in ("kNcoPhasorTile", "kNcoRing"):
        with pytest.raises(RuntimeError, match=name):
            nco_sweep.variant_source(src.replace(name, "kTile"), 16, 7)

"""K-NCO's plain loop on the CPU (kernels/nco_pll.py
``nco_pll_phasor_plain``, ops/nco_pll.py ``nco_pll_subcarrier``): the
subcarrier ``−sin 2φ`` and the carried state against a float64 loop in
the scan's order, over chained chunks at the ``wbfm24_pll`` cell's rate
and gains, at a wide loop (where the series' guard redoes tiles with the
exact rotation) and from a wild initial phase; a loop reset each chunk;
the guard tile by tile; the entry that normalises the pilot; the phase
output (``nco_pll_track``'s trajectory on the card) against the float64
loop over the kernel's walk of a row and from a wild initial phase.

The plain loop runs one Python iteration a sample, about 35 µs for 4
rows, so the chunks are 0.1 s of a 240 kS/s station. Imports no JAX."""

import math

import numpy as np
import pytest
import torch

from radiocore_tpu_torch.kernels import build
from radiocore_tpu_torch.kernels import nco_pll as knco
from radiocore_tpu_torch.ops import nco_pll as npl

torch.set_num_threads(2)

FS = 240_000          # the wbfm24 cells' station rate
N = 24_000            # samples a chunk
CHUNKS = 3
ROWS = 4
# Two float32 loops and the float64 one drift apart by up to 1.7e-5 rad
# over a locked chunk (tests/test_torch_pipeline_pll.py): the subcarrier
# -sin 2φ then moves by up to twice that. Acquiring from phase 0 (the
# first chunk) float32 loops drift further before the feedback pulls them
# together: the scan-order float32 loop (nco_pll_track_plain) reads
# 1.6e-4 on these pilots.
DRIFT_RAD = 1.7e-5
SUB_LOCKED = 2 * DRIFT_RAD
SUB_ACQUIRE = 4e-4
# From a given phase with the pilot in step, a float32 loop and the
# float64 one part by up to about 3e-5 rad over the first few thousand
# samples before the feedback pulls them together (the float32 scan reads
# as much as the phasor): chip_smoke.py NCO_PLAIN_MAX.
START_RAD = 5e-5
FREQ = 1e-7           # rad a sample


def _pilots(seed, rows=ROWS, n=CHUNKS * N, amp=0.1):
    """Raw pilots as the cell's bandpass gives them: 19 kHz + k/4 Hz, k
    in [-8, 8], each at its own phase, amplitude ``amp`` (so the loop
    needs its 1/RMS), noise at 1% of it; float32 ``(rows, n)``."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    f = 19e3 + rng.integers(-8, 9, rows)[:, None] / 4
    phi = rng.uniform(0, 2 * np.pi, rows)[:, None]
    x = amp * np.sqrt(2) * np.sin(2 * np.pi * f * t + phi)
    return (x + 0.01 * amp * rng.standard_normal((rows, n))).astype(
        np.float32)


def _loop64(x, gains, phase, freq):
    """The loop in float64 in the scan's order over ``x`` ``(rows, n)``
    (already normalised): the trajectory and the end state."""
    kp, ki, w0 = gains
    xs = np.ascontiguousarray(x.T)
    traj = np.empty_like(xs)
    ph, fr = phase.copy(), freq.copy()
    for t in range(xs.shape[0]):
        traj[t] = ph
        err = xs[t] * np.cos(ph)
        fr = fr + ki * err
        ph = ph + w0 + fr + kp * err
        ph = np.where(ph > np.pi, ph - 2 * np.pi, ph)
    return traj.T, ph, fr


def _scale(x):
    rms = torch.sqrt(torch.mean(x * x, dim=-1))
    return torch.reciprocal(torch.clamp_min(rms,
                                            torch.finfo(torch.float32).tiny))


def _wrapped(a, b):
    d = (np.asarray(a, np.float64) - np.asarray(b, np.float64)
         + np.pi) % (2 * np.pi) - np.pi
    return float(np.abs(d).max())


def _chained(x, gains, phase0, reset=False):
    """The plain loop and the float64 one over ``CHUNKS`` chained chunks
    of ``x`` from ``phase0`` (frequency 0); ``reset``: the plain loop
    starts each chunk from that state again. Returns per chunk
    ``(sub, phase, freq, want_sub, want_phase, want_freq)`` and the
    tiles the plain loop redid."""
    p32 = torch.full((ROWS,), phase0, dtype=torch.float32)
    f32 = torch.zeros(ROWS)
    p64, f64 = np.full(ROWS, float(p32[0])), np.zeros(ROWS)
    before = knco.redone.read()
    out = []
    for k in range(CHUNKS):
        chunk = torch.from_numpy(x[:, k * N:(k + 1) * N])
        c64 = chunk.double().numpy()
        rms = np.sqrt(np.mean(c64 * c64, axis=-1, keepdims=True))
        traj, p64, f64 = _loop64(c64 / rms, gains, p64, f64)
        if reset:
            p32 = torch.full((ROWS,), phase0, dtype=torch.float32)
            f32 = torch.zeros(ROWS)
        sub, p32, f32 = knco.nco_pll_subcarrier_plain(
            chunk, _scale(chunk), *gains, p32, f32)
        out.append((sub.numpy(), p32.numpy(), f32.numpy(),
                    -np.sin(2 * traj), p64, f64))
    return out, knco.redone.read() - before


CASES = {
    # The cell's loop (50 Hz, damping 0.7071): |psi| stays near 1e-3.
    "cell": (50.0, 0.0),
    # A 5 kHz loop: |psi| reaches 0.05, past the series' limit in every
    # tile, so every tile is done again with the exact rotation.
    "wide": (5000.0, 0.0),
    # A wild initial phase: the phasor has no phase to wrap, so the
    # series holds from the first sample.
    "phase40": (50.0, 40.0),
}


@pytest.fixture(scope="module")
def runs():
    x = _pilots(22)
    return {name: _chained(x, npl.pll_design(FS, 19e3, bw), phase0)
            for name, (bw, phase0) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_the_float64_loop_over_chained_chunks(runs, case):
    out, redid = runs[case]
    for k, (sub, ph, fr, want, ph64, fr64) in enumerate(out):
        bound = SUB_ACQUIRE if k == 0 else SUB_LOCKED
        assert np.abs(sub - want).max() <= bound, k
        assert _wrapped(ph, ph64) <= DRIFT_RAD, k
        np.testing.assert_allclose(fr, fr64, atol=FREQ, rtol=0)
    # The state moves on: the integrator holds each pilot's offset.
    assert np.abs(out[-1][2]).max() > 0
    tiles = CHUNKS * ROWS * (N // knco.PHASOR_TILE)
    assert redid == (tiles if case == "wide" else 0), redid


def test_a_loop_reset_each_chunk_fails(runs):
    x = _pilots(22)
    out, _ = _chained(x, npl.pll_design(FS, 19e3, 50.0), 0.0, reset=True)
    locked, _ = runs["cell"]
    for k in range(1, CHUNKS):
        sub, want = out[k][0], locked[k][3]
        assert np.abs(sub - want).max() > 100 * SUB_LOCKED, k


def test_the_guard_redoes_only_the_tiles_past_the_limit():
    """A spike in one tile of one row sends that tile of that row, and no
    other, through the exact rotation: one count, and the other row is
    what it is without the spike; the spiked row's next tiles are back on
    the series."""
    tile = knco.PHASOR_TILE
    n = 10 * tile + 7
    x = torch.from_numpy(_pilots(5, rows=2, n=n))
    s = _scale(x)
    gains = npl.pll_design(FS, 19e3, 50.0)
    zeros = torch.zeros(2)
    spiked = x.clone()
    # Four samples, so that the detector's cos φ is large at one of them:
    # |psi| up to 40 (kp + ki) ≈ 0.024.
    spiked[1, 3 * tile + 5:3 * tile + 9] = 40.0 / float(s[1])
    before = knco.redone.read()
    clean = knco.nco_pll_subcarrier_plain(x, s, *gains, zeros, zeros)
    assert knco.redone.read() == before
    got = knco.nco_pll_subcarrier_plain(spiked, s, *gains, zeros, zeros)
    assert knco.redone.read() - before == 1
    assert torch.equal(got[0][0], clean[0][0])
    assert torch.equal(got[1][0], clean[1][0])
    first = slice(0, 3 * tile)
    assert torch.equal(got[0][1, first], clean[0][1, first])
    assert not torch.equal(got[0][1], clean[0][1])


def test_the_series_holds_to_two_to_the_minus_26():
    """(1 − ψ²/2, ψ) is e^{jψ} within 2^-26 for every |ψ| up to the
    limit, and no longer at twice it; the kernel's limit and tile are the
    plain loop's."""
    psi = np.linspace(-knco.PSI_MAX, knco.PSI_MAX, 10_001)
    err = np.abs(np.exp(1j * psi) - (1 - psi ** 2 / 2 + 1j * psi))
    assert err.max() < 2.0 ** -26
    far = 2 * knco.PSI_MAX
    assert abs(np.exp(1j * far) - (1 - far ** 2 / 2 + 1j * far)) > 2 ** -26
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    assert f"kNcoPsiMax = {knco.PSI_MAX!r}f;" in src
    assert f"kNcoPhasorTile = {knco.PHASOR_TILE};" in src


def test_phasor_constants_are_float32_values():
    """The gains over √2 (the phasor's length) and e^{j w0}, each a
    float32 value rounded once from float64."""
    kp, ki, w0 = npl.pll_design(FS, 19e3, 50.0)
    ak, ai, cw, sw = knco.phasor_constants(kp, ki, w0)
    for v in (ak, ai, cw, sw):
        assert float(np.float32(v)) == v
    kk = float(np.float32(ki) + np.float32(kp))
    assert ak == float(np.float32(kk / math.sqrt(2)))
    assert ai == float(np.float32(float(np.float32(ki)) / math.sqrt(2)))
    assert abs(complex(cw, sw) - complex(math.cos(w0), math.sin(w0))) < 1e-7


def test_nan_row_stays_nan():
    """A NaN pilot row: its subcarrier is NaN from the second sample on
    (the first is that of the phase it was given), its state NaN, and the
    other rows are what they are without it. NaN takes no guard."""
    x = torch.from_numpy(_pilots(7, rows=3, n=4 * knco.PHASOR_TILE + 3))
    gains = npl.pll_design(FS, 19e3, 50.0)
    phase0 = torch.tensor([0.3, -0.7, 1.1])
    zeros = torch.zeros(3)
    dead = x.clone()
    dead[1] = float("nan")
    before = knco.redone.read()
    got = knco.nco_pll_subcarrier_plain(dead, _scale(dead), *gains, phase0,
                                        zeros)
    assert knco.redone.read() == before
    clean = knco.nco_pll_subcarrier_plain(x, _scale(x), *gains, phase0, zeros)
    assert float(got[0][1, 0]) == pytest.approx(-math.sin(2 * -0.7),
                                                abs=1e-6)
    assert bool(got[0][1, 1:].isnan().all())
    assert bool(got[1][1].isnan()) and bool(got[2][1].isnan())
    for r in (0, 2):
        assert torch.equal(got[0][r], clean[0][r])
        assert torch.equal(got[1][r], clean[1][r])
        assert torch.equal(got[2][r], clean[2][r])


def test_the_entry_is_the_trajectory_s_subcarrier():
    """``nco_pll_subcarrier`` on the raw pilot gives what
    ``nco_pll_track`` (on the CPU the scan-order loop) gives on the pilot
    divided by its RMS, through ``pll_subcarrier``,
    within the two float32 loops' drift; the pilot's level does not
    matter; a CPU tensor counts no launch; the state given is left as it
    was."""
    x = torch.from_numpy(_pilots(3, rows=2, n=N))
    gains = npl.pll_design(FS, 19e3, 50.0)
    state = npl.pll_init((2,), device="cpu")
    launches = knco.launches.count
    sub, new = npl.nco_pll_subcarrier(x, gains, state)
    assert knco.launches.count == launches
    assert not bool(state.phase.any()) and bool(new.freq.any())
    rms = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    traj, old = npl.nco_pll_track(x / rms, gains, state)
    want = npl.pll_subcarrier(traj, 2, "imag")
    assert float((sub - want)[:, N // 2:].abs().max()) <= 2 * SUB_LOCKED
    assert _wrapped(new.phase, old.phase) <= 2 * DRIFT_RAD
    np.testing.assert_allclose(new.freq, old.freq, atol=FREQ, rtol=0)
    loud, _ = npl.nco_pll_subcarrier(8.0 * x, gains, state)
    assert torch.equal(loud, sub)


def _walk_pilots(n, aligned, seed):
    """Three rms-normalised pilots at 262 144 S/s, 19 kHz + 0, 2, −1 Hz,
    noise at 0.1 of the rms; float32 ``(3, n)``, the rows 4 bytes off a
    16-byte boundary unless ``aligned`` (a view with a row stride of
    ``n + 1``)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 262_144
    f = 19e3 + np.array([[0.0], [2.0], [-1.0]])
    buf = np.empty((3, n + 1), np.float32)
    x = buf[:, :n] if aligned else buf[:, 1:]
    x[:] = (np.sqrt(2.0) * np.sin(2 * np.pi * f * t
                                  + np.array([[0.1], [1.0], [2.5]]))
            + 0.1 * rng.standard_normal((3, n)))
    return x


@pytest.mark.parametrize("n,aligned", [(4096, True), (4099, True),
                                       (4097, False), (7, True), (16, True)])
def test_phase_output_walks_every_sample_once(n, aligned):
    """The phase output over the kernel's walk of a row (80-sample tiles,
    by 16-byte accesses on a 16-byte boundary and by scalar ones off it,
    the ragged end sample by sample): its first sample is the phase
    given; the trajectory and the end phase within DRIFT_RAD of the
    float64 loop modulo 2π, the frequency within FREQ; the end state is
    the subcarrier output's bit for bit, and the subcarrier is −sin 2φ of
    the trajectory within SUB_LOCKED. At a 5 kHz loop every whole tile of
    every row is redone, in both outputs alike, and the ragged end is
    not."""
    x = _walk_pilots(n, aligned, n)
    rng = np.random.default_rng(n)
    phase0 = rng.uniform(-1, 1, 3).astype(np.float32)
    freq0 = (1e-5 * rng.standard_normal(3)).astype(np.float32)
    for bw, tiles in ((50.0, 0), (5000.0, 3 * (n // knco.PHASOR_TILE))):
        gains = npl.pll_design(262_144, 19e3, bw)
        args = (torch.from_numpy(x), torch.ones(3), *gains,
                torch.from_numpy(phase0), torch.from_numpy(freq0))
        before = knco.redone.read()
        traj, phase, freq = knco.nco_pll_phasor_plain(*args, "phase")
        redid = knco.redone.read() - before
        sub, sub_phase, sub_freq = knco.nco_pll_subcarrier_plain(*args)
        assert redid == knco.redone.read() - before - redid == tiles, bw
        assert torch.equal(traj[:, 0], args[-2])
        assert torch.equal(phase, sub_phase) and torch.equal(freq, sub_freq)
        want = _loop64(x.astype(np.float64), gains,
                       phase0.astype(np.float64), freq0.astype(np.float64))
        assert _wrapped(traj, want[0]) <= DRIFT_RAD, bw
        assert _wrapped(phase, want[1]) <= DRIFT_RAD, bw
        np.testing.assert_allclose(freq, want[2], atol=FREQ, rtol=0)
        assert float((sub + torch.sin(2 * traj)).abs().max()) <= SUB_LOCKED


@pytest.mark.parametrize("wild", [50.0, -50.0])
def test_phase_output_from_a_wild_initial_phase(wild):
    """An initial phase of ±50 rad, the pilot in step with it modulo 2π:
    the phase output's first sample is that phase, as the scan's; no tile
    is redone (the phasor has no phase to wrap); the trajectory and the
    end phase stay within START_RAD of the float64 loop modulo 2π (a row
    started in range beside it too), the frequency within FREQ."""
    rng = np.random.default_rng(13)
    theta = 2 * np.pi * 19e3 * np.arange(2048) / FS + np.array([[wild],
                                                                 [0.4]])
    x = torch.from_numpy((0.1 * np.sqrt(2.0) * np.sin(theta) + 1e-3
                          * rng.standard_normal(theta.shape)).astype(
                              np.float32))
    s = _scale(x)
    gains = npl.pll_design(FS, 19e3, 50.0)
    phase0 = torch.tensor([wild, 0.4])
    zeros = torch.zeros(2)
    before = knco.redone.read()
    traj, phase, freq = knco.nco_pll_phasor_plain(x, s, *gains, phase0,
                                                  zeros, "phase")
    assert knco.redone.read() == before
    assert float(traj[0, 0]) == wild
    x64 = x.double().numpy()
    want = _loop64(x64 / np.sqrt(np.mean(x64 * x64, -1, keepdims=True)),
                   gains, phase0.double().numpy(), np.zeros(2))
    assert _wrapped(traj, want[0]) <= START_RAD
    assert _wrapped(phase, want[1]) <= START_RAD
    np.testing.assert_allclose(freq, want[2], atol=FREQ, rtol=0)


@pytest.mark.parametrize("rows, sms, blocks, lanes", [
    (24, 132, 24, 1),       # the wbfm24 cells: one row a block
    (64, 132, 64, 1),       # the 64-station plan
    (132, 132, 132, 1),     # a row on every SM
    (133, 132, 67, 2),      # past one row an SM: two lanes a chain warp
    (265, 132, 67, 4),
    (600, 132, 75, 8),
    (4224, 132, 132, 32),   # a full chain warp on every SM
    (4225, 132, 133, 32),   # past that, blocks share SMs
    (1, 1, 1, 1),
    (17, 4, 3, 8),
])
def test_launch_geometry(rows, sms, blocks, lanes):
    """Rows and SMs → blocks and the chain warp's lanes: one block an SM
    while the rows allow, a power of two of rows a block, every row in
    one block; each block's helper warps are the source's constant."""
    import re
    got = knco.nco_geometry(rows, sms)
    assert got == (blocks, lanes)
    assert (blocks - 1) * lanes < rows <= blocks * lanes
    assert lanes & (lanes - 1) == 0 and lanes <= knco.CHAIN_LANES
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    assert re.search(r"constexpr int kNcoHelpers = (\d+);",
                     src).group(1) == str(knco.HELPERS)
    assert "dim3 block(rc::kNcoThreads * (1 + rc::kNcoHelpers));" in src


def test_launch_geometry_refuses_no_rows():
    for rows, sms in ((0, 132), (24, 0)):
        with pytest.raises(ValueError):
            knco.nco_geometry(rows, sms)


def test_the_block_fits_the_card_at_every_geometry():
    """The kernel's constants are the launcher's, and its shared memory,
    as csrc/nco_pll.cu nco_smem_bytes computes it (the ring's (a, b) and
    w a row, its raw tiles, the barriers and the rows' gains), fits an
    H100's 227 KB a block at a full chain warp and grows with the rows."""
    import re
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (kNco\w+) = ([\w ]+?);", src) if v.isdigit()}
    assert const["kNcoThreads"] == knco.CHAIN_LANES
    assert const["kNcoHelpers"] == knco.HELPERS
    # The derived constants and the function's body, as C has them, in
    # integer arithmetic: every operand is a whole number.
    derived = dict(re.findall(r"constexpr int (kNco\w+) = ([^;]+);", src))
    body = re.search(r"inline long long nco_smem_bytes\(int lanes\) \{"
                     r"\s*return ([^;]+);", src).group(1)

    def c_int(expr, env):
        expr = re.sub(r"//[^\n]*", "", expr)
        expr = re.sub(r"(\d+)LL\b", r"\1", expr).replace("/", "//")
        return int(eval(f"({expr})", {}, env))

    env = dict(const)
    for name in ("kNcoSlot", "kNcoRingStride", "kNcoRawTiles",
                 "kNcoRawStride"):
        env[name] = c_int(derived[name], env)
    smem = [c_int(body, dict(env, lanes=lanes)) for lanes in (1, 2, 32)]
    assert smem[0] < smem[1] < smem[2] <= 232_448, smem
    # Its 16 * lanes * ... term is the ring's (a, b) and w and the raw
    # tiles, in float4s a row.
    tile, ring = const["kNcoPhasorTile"], const["kNcoRing"]
    per_row = 16 * (2 * (ring * tile // 2 + 1)
                    + (const["kNcoAhead"] + 1) * tile // 4)
    assert smem[2] - smem[0] >= 31 * per_row


def test_the_c_entry_takes_both_counters_and_the_geometry():
    """``rc_nco_pll``'s parameters as the source declares them are the
    ctypes signature the launcher calls with: ``starved`` beside
    ``redone``, then the block's ``lanes``."""
    import re
    src = (build.CSRC_DIR / "nco_pll.cu").read_text()
    params = re.search(r'extern "C" int rc_nco_pll\(([^)]*)\)', src).group(1)
    decls = [" ".join(p.split()) for p in params.split(",")]
    names = [d.split()[-1].lstrip("*") for d in decls]
    kinds = {"void*": build._P, "long long": build._L, "int": build._I,
             "float": build._F}
    types = [kinds[" ".join(d.replace("const ", "").split()[:-1])]
             for d in decls]
    assert types == build._SIGNATURES["rc_nco_pll"]
    assert names[names.index("redone") + 1] == "starved"
    assert names[names.index("n") + 1:names.index("n") + 3] == ["lanes",
                                                                "ak"]


def test_starved_is_a_counter_of_its_own(monkeypatch):
    """``starved`` counts apart from ``redone``, one int64 a device; the
    plain loop, which has no helpers, leaves it as it is while a wide
    loop adds to ``redone``; its first use inside a graph capture is
    refused by name."""
    assert knco.starved is not knco.redone
    t = knco.starved.tensor("cpu")
    assert t.dtype == torch.int64 and t.shape == (1,)
    assert t.data_ptr() != knco.redone.tensor("cpu").data_ptr()
    assert knco.starved.tensor("cpu") is t
    x = torch.from_numpy(_pilots(11, rows=2, n=3 * knco.PHASOR_TILE))
    zeros = torch.zeros(2)
    before = (knco.starved.read(), knco.redone.read())
    knco.nco_pll_subcarrier_plain(x, _scale(x), *npl.pll_design(
        FS, 19e3, 5000.0), zeros, zeros)
    assert knco.starved.read() == before[0]
    assert knco.redone.read() - before[1] == 2 * 3
    knco.starved.tensor("cpu").add_(2)
    assert knco.starved.read() == before[0] + 2
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="nco_pll.starved"):
        knco.TileCounter("starved").tensor("cuda:0")

"""K-NCO on the card, at the ``wbfm24_pll`` plan (24 stations of 240 kS/s
on a 10 MS/s band, the ``resident_pll`` mix's band): both outputs of the
kernel (the subcarrier, and the phase, ``nco_pll_track``'s trajectory)
against its plain loop on the pilots the step hands it, on and off a
16-byte boundary with a ragged end, at a wide loop whose tiles are redone
(as many as the plain loop redoes), with more rows than four an SM (so
that a chain warp holds several rows) and with NaN rows, and at 64 ×
262 144 from a carried state; the compiled step against its eager body
with one launch a step and no tile redone or starved; the counters over
20 s of the cell's traffic; the kernel's name in a profile; the phase
output against a float64 loop, and under a CUDA graph against eager with
one launch a call.

Every test here needs a CUDA card and skips without one. This file
imports no JAX, so that it runs where only the port is installed; from
the repository's root on a machine with a card:
``python3 -m pytest tests/test_torch_nco_phasor_card.py -q --noconftest``
(``tests/conftest.py`` sets JAX up for the CPU tests).
"""

import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.card

SEED = (1 << 31) + 2222
CHUNKS = 3
# The kernel against its plain loop: two float32 loops that round
# differently drift apart by up to 5e-5 rad (chip_smoke.py
# NCO_PLAIN_MAX), the subcarrier -sin 2φ by twice that; against the
# float64 loop, chip_smoke.py NCO_F64_MAX.
PLAIN_RAD = 5e-5
SUB = 2 * PLAIN_RAD
F64_RAD = 2e-4
SOAK_S = 20.0


@pytest.fixture(scope="module")
def plan():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import pilots
    with open(ROOT / "portbench/configs/wbfm24_pll.json") as f:
        config = json.load(f)
    with open(ROOT / "portbench/traffic/resident_pll.json") as f:
        traffic = json.load(f)
    card = torch.device("cuda", 0)
    return config, pilots.band_pool(SEED, config, traffic, card), card


def _step(config, card):
    from portbench import signals
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    return make_multi_station_step(
        config["band_rate"], signals.offsets(config), config["station_rate"],
        config["audio_rate"], config["deemphasis_s"], mode="exact",
        pll="nco", device=card)


@pytest.fixture(scope="module")
def handed(plan):
    """What the eager step hands the loop on the pool's second chunk,
    after a step on the first: ``(pilot (24, 240000), gains, state)``."""
    from radiocore_tpu_torch.models import wbfm
    config, pool, card = plan
    step, state = _step(config, card)
    seen = []
    loop = wbfm.nco_pll_subcarrier

    def spy(pilot, gains, st):
        seen.append((pilot.clone(), gains, st))
        return loop(pilot, gains, st)

    wbfm.nco_pll_subcarrier = spy
    try:
        _, state = step.eager(pool[0], state)
        step.eager(pool[1], state)
    finally:
        wbfm.nco_pll_subcarrier = loop
    torch.cuda.synchronize()
    return seen[1]


def _scale(x):
    rms = torch.sqrt(torch.mean(x * x, dim=-1))
    return torch.reciprocal(torch.clamp_min(rms,
                                            torch.finfo(torch.float32).tiny))


def _wrapped_gap(a, b):
    return ((a.double() - b.double() + math.pi) % (2 * math.pi)
            - math.pi).abs()


def _against_plain(x, gains, phase, freq, output="subcarrier"):
    """The kernel and the plain loop on ``x``, ``output`` of either: the
    largest gaps of the output (modulo 2π for the phase), the final phase
    (modulo 2π) and the frequency over the rows that are not NaN, whether
    the NaN rows are NaN in both alike, and the tiles each redid."""
    from radiocore_tpu_torch.kernels import nco_pll as knco
    if output == "subcarrier":
        s = _scale(x)
    else:
        s = torch.ones(x.shape[0], device=x.device)
    before = (knco.redone.read(x.device), knco.redone.read("cpu"))
    if output == "subcarrier":
        got = knco.nco_pll_subcarrier_rows(x, s, *gains, phase, freq)
    else:
        got = knco.nco_pll_track_rows(x, *gains, phase, freq)
    ref = knco.nco_pll_phasor_plain(x.cpu(), s.cpu(), *gains, phase.cpu(),
                                    freq.cpu(), output)
    redid = (knco.redone.read(x.device) - before[0],
             knco.redone.read("cpu") - before[1])
    got = [v.cpu() for v in got]
    live = ~x.cpu().isnan().any(-1)
    dead = [bool(v[0][~live, 1:].isnan().all()) and bool(v[1][~live].isnan()
                                                         .all())
            for v in (got, ref)]
    if output == "subcarrier":
        out = float((got[0][live] - ref[0][live]).abs().max())
    else:
        out = float(_wrapped_gap(got[0][live], ref[0][live]).max())
    return (out, float(_wrapped_gap(got[1][live], ref[1][live]).max()),
            float((got[2][live] - ref[2][live]).abs().max()),
            redid, all(dead))


def _holds(gaps, output):
    bound = SUB if output == "subcarrier" else PLAIN_RAD
    return (gaps[0] <= bound and gaps[1] <= PLAIN_RAD and gaps[2] <= 1e-7
            and gaps[4])


def test_kernel_matches_its_plain_loop_on_the_cell_pilots(handed):
    pilot, gains, state = handed
    assert tuple(pilot.shape) == (24, 240_000)
    gaps = _against_plain(pilot, gains, state.phase, state.freq)
    assert _holds(gaps, "subcarrier"), gaps
    assert gaps[3] == (0, 0)


@pytest.mark.parametrize("output", ["subcarrier", "phase"])
def test_kernel_off_a_16_byte_boundary_at_an_odd_length(handed, output):
    """Rows off a 16-byte boundary (4-byte copies and stores) with a
    ragged end (48 001 = 600 tiles and one sample)."""
    pilot, gains, state = handed
    x = pilot[:, 1:1 + 48_001]
    assert x.data_ptr() % 16 != 0 and x.shape[-1] % 2 == 1
    gaps = _against_plain(x, gains, state.phase, state.freq, output)
    assert _holds(gaps, output), gaps
    assert gaps[3] == (0, 0)


def test_a_wide_loop_redoes_tiles_on_the_card_as_in_the_plain_loop(handed):
    """A 5 kHz loop: |psi| passes the series' limit, every tile is done
    again with the exact rotation on the card as in the plain loop, and
    the two still agree."""
    from radiocore_tpu_torch.kernels import nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import pll_design
    pilot, _, state = handed
    x = pilot[:4, :48_000].contiguous()
    wide = pll_design(240_000, 19e3, 5000.0)
    for output in ("subcarrier", "phase"):
        # The phase output reads its pilot with a scale of 1: give it the
        # normalised pilot, which the subcarrier output normalises itself.
        xo = x if output == "subcarrier" else x * _scale(x)[:, None]
        gaps = _against_plain(xo, wide, state.phase[:4], state.freq[:4],
                              output)
        assert _holds(gaps, output), (output, gaps)
        redid = gaps[3]
        assert redid[0] == redid[1] == 4 * (48_000 // knco.PHASOR_TILE)


def test_graph_equals_eager_with_one_launch_and_no_tile_redone(plan):
    from radiocore_tpu_torch.kernels import nco_pll as knco
    config, pool, card = plan
    step, state = _step(config, card)
    graphed, eager = state, state
    launches = knco.launches.count
    redone = knco.redone.read(card)
    starved = knco.starved.read(card)
    for k in range(CHUNKS):
        a_g, graphed = step(pool[k], graphed)
        a_e, eager = step.eager(pool[k], eager)
        for got, want in ((a_g, a_e), (graphed["pll"].phase,
                                       eager["pll"].phase),
                          (graphed["pll"].freq, eager["pll"].freq),
                          (graphed["deemph_l"], eager["deemph_l"])):
            assert torch.equal(got, want), k
    torch.cuda.synchronize()
    assert step.graph_count == 1
    # Warm-up and capture leave the counter as it was: each call, graphed
    # or eager, counts one launch.
    assert knco.launches.count - launches == 2 * CHUNKS
    assert knco.redone.read(card) == redone
    assert knco.starved.read(card) == starved


def test_no_tile_redone_over_20_s_of_the_cell(plan):
    from radiocore_tpu_torch.kernels import nco_pll as knco
    config, pool, card = plan
    step, state = _step(config, card)
    _, state = step(pool[0], state)
    before = (knco.redone.read(card), knco.launches.count,
              knco.starved.read(card))
    steps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < SOAK_S:
        _, state = step(pool[(steps + 1) % pool.shape[0]], state)
        steps += 1
    torch.cuda.synchronize()
    assert knco.launches.count - before[1] == steps > 1000
    assert knco.redone.read(card) == before[0]
    # The helpers kept ahead of every chain lane: the chain set the pace.
    assert knco.starved.read(card) == before[2]


def test_the_profiler_names_the_kernel(handed):
    from torch.profiler import ProfilerActivity, profile
    from radiocore_tpu_torch.kernels import nco_pll as knco
    pilot, gains, state = handed
    s = _scale(pilot)
    knco.nco_pll_subcarrier_rows(pilot, s, *gains, state.phase, state.freq)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            knco.nco_pll_subcarrier_rows(pilot, s, *gains, state.phase,
                                         state.freq)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("nco_pll_kernel_phasor" in n for n in names), names


def _loop64(x, gains, phase, freq):
    """The loop in float64 in the scan's order over ``x`` ``(rows, n)``:
    the trajectory and the end state, NumPy."""
    import numpy as np
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


def _wrapped(a, b):
    return float(((a.double() - b.double() + math.pi) % (2 * math.pi)
                  - math.pi).abs().max())


def test_phase_output_matches_its_plain_loop_and_float64(handed):
    """``nco_pll_track`` on the card (the kernel's phase output, a scale
    of 1) on the pilot the step hands the loop, divided by its RMS: the
    first sample is the phase given; the trajectory and the end phase
    within PLAIN_RAD of its plain loop and within F64_RAD of the float64
    loop modulo 2π, the frequency within 1e-7 of both; no tile redone."""
    from radiocore_tpu_torch.kernels import nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import nco_pll_track
    pilot, gains, state = handed
    x = pilot * _scale(pilot)[:, None]
    before = knco.redone.read(x.device)
    traj, new = nco_pll_track(x, gains, state)
    traj, phase, freq = traj.cpu(), new.phase.cpu(), new.freq.cpu()
    assert knco.redone.read(x.device) == before
    assert torch.equal(traj[:, 0], state.phase.cpu())
    held = (x.cpu(), state.phase.cpu(), state.freq.cpu())
    ref = knco.nco_pll_phasor_plain(held[0], torch.ones(x.shape[0]), *gains,
                                    *held[1:], "phase")
    x64, p64, f64 = (v.double().numpy() for v in held)
    want = [torch.from_numpy(v) for v in _loop64(x64, gains, p64, f64)]
    for other, bound in ((ref, PLAIN_RAD), (want, F64_RAD)):
        gaps = (_wrapped(traj, other[0]), _wrapped(phase, other[1]),
                float((freq.double() - other[2].double()).abs().max()))
        assert max(gaps[:2]) <= bound and gaps[2] <= 1e-7, (bound, gaps)


def test_phase_output_graph_equals_eager_with_one_launch_a_call(handed):
    from radiocore_tpu_torch.kernels import nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import nco_pll_track
    from radiocore_tpu_torch.runtime.graphs import compile_step
    pilot, gains, state = handed
    x = pilot * _scale(pilot)[:, None]
    step = compile_step(lambda x, st: nco_pll_track(x, gains, st), x.device)
    launches = knco.launches.count
    calls = [step(x, state), step(x, state), step.eager(x, state)]
    torch.cuda.synchronize()
    assert step.graph_count == 1
    # Warm-up and capture leave the counter as it was.
    assert knco.launches.count - launches == len(calls)
    want = calls[-1]
    for got in calls[:2]:
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].phase, want[1].phase)
        assert torch.equal(got[1].freq, want[1].freq)


def _synthetic(card, rows, n, seed, rate):
    """Raw pilots as the cell's bandpass gives them, on the card: 19 kHz
    within ±3 Hz at ``rate`` samples a second, each at its own phase,
    amplitude 0.1, noise at a tenth of it; float32 ``(rows, n)``."""
    gen = torch.Generator(device=card).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=card)
    t = torch.arange(n, **f64) / rate
    f = 19e3 + 6.0 * (torch.rand(rows, 1, generator=gen, **f64) - 0.5)
    phi = 2 * math.pi * torch.rand(rows, 1, generator=gen, **f64)
    x = (0.1 * math.sqrt(2.0) * torch.sin(2 * math.pi * f * t + phi)
         + 0.01 * torch.randn(rows, n, generator=gen, **f64))
    return x.float()


@pytest.mark.parametrize("output", ["subcarrier", "phase"])
def test_kernel_at_64_by_262144_from_a_carried_state(plan, output):
    """The 64-station plan's shape: a first chunk from phase 0 through the
    kernel, then the next chunk from the state it carried, kernel against
    plain loop; no tile redone."""
    from radiocore_tpu_torch.kernels import nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import pll_design
    _, _, card = plan
    rows, n = 64, 262_144
    # One second of 262 144 S/s, the loop designed for that rate.
    x = _synthetic(card, rows, 2 * n, SEED + 64, n).reshape(rows, 2, n)
    gains = pll_design(n, 19e3, 50.0)
    zeros = torch.zeros(rows, device=card)
    first = x[:, 0].contiguous()
    _, phase, freq = knco.nco_pll_subcarrier_rows(first, _scale(first),
                                                  *gains, zeros, zeros)
    gaps = _against_plain(x[:, 1].contiguous(), gains, phase, freq, output)
    assert _holds(gaps, output), gaps
    assert gaps[3] == (0, 0)


@pytest.mark.parametrize("output", ["subcarrier", "phase"])
def test_several_rows_a_chain_warp(handed, output):
    """More rows than four an SM: the launcher puts several rows on each
    chain warp, and every row is still its plain loop's."""
    from radiocore_tpu_torch.kernels import nco_pll as knco
    pilot, gains, state = handed
    sms = torch.cuda.get_device_properties(pilot.device).multi_processor_count
    rows = 4 * sms + 8
    _, lanes = knco.nco_geometry(rows, sms)
    assert lanes > 1
    pick = torch.arange(rows, device=pilot.device) % pilot.shape[0]
    x = pilot[pick, :4_003].contiguous()
    spread = torch.linspace(-3.0, 3.0, rows, device=pilot.device)
    gaps = _against_plain(x, gains, state.phase[pick] + spread,
                          state.freq[pick], output)
    assert _holds(gaps, output), gaps
    assert gaps[3] == (0, 0)


@pytest.mark.parametrize("output", ["subcarrier", "phase"])
def test_nan_rows(handed, output):
    """NaN pilot rows: NaN in kernel and plain loop alike, state and all,
    and every other row what it is without them, bit for bit; NaN takes
    no guard."""
    from radiocore_tpu_torch.kernels import nco_pll as knco
    pilot, gains, state = handed
    x = pilot[:, :8_000].clone()
    x[[3, 17]] = float("nan")
    gaps = _against_plain(x, gains, state.phase, state.freq, output)
    assert _holds(gaps, output), gaps
    assert gaps[3] == (0, 0)
    clean = pilot[:, :8_000].contiguous()
    if output == "subcarrier":
        a = knco.nco_pll_subcarrier_rows(x, _scale(x), *gains, state.phase,
                                         state.freq)
        b = knco.nco_pll_subcarrier_rows(clean, _scale(clean), *gains,
                                         state.phase, state.freq)
    else:
        a = knco.nco_pll_track_rows(x, *gains, state.phase, state.freq)
        b = knco.nco_pll_track_rows(clean, *gains, state.phase, state.freq)
    keep = [r for r in range(x.shape[0]) if r not in (3, 17)]
    for u, v in zip(a, b):
        assert torch.equal(u[keep], v[keep])

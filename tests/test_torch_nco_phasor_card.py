"""K-NCO on the card, at the ``wbfm24_pll`` plan (24 stations of 240 kS/s
on a 10 MS/s band, the ``resident_pll`` mix's band): the kernel's
subcarrier output against its plain loop on the pilots the step hands it,
on and off a 16-byte boundary; the compiled step against its eager body
with one launch a step and no tile redone; the redone-tile counter on a
wide loop and over 20 s of the cell's traffic; the kernel's name in a
profile; its phase output (``nco_pll_track``'s trajectory) against its
plain loop and a float64 loop on the same pilots, and under a CUDA graph
against eager with one launch a call.

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


def _against_plain(x, gains, phase, freq):
    """The kernel and the plain loop on ``x``: the largest gaps of the
    subcarrier, the phase (modulo 2π) and the frequency, and the tiles
    each redid."""
    from radiocore_tpu_torch.kernels import nco_pll as knco
    s = _scale(x)
    before = (knco.redone.read(x.device), knco.redone.read("cpu"))
    got = knco.nco_pll_subcarrier_rows(x, s, *gains, phase, freq)
    ref = knco.nco_pll_subcarrier_plain(x.cpu(), s.cpu(), *gains,
                                        phase.cpu(), freq.cpu())
    redid = (knco.redone.read(x.device) - before[0],
             knco.redone.read("cpu") - before[1])
    d = (got[1].cpu().double() - ref[1].double() + math.pi) % (
        2 * math.pi) - math.pi
    return (float((got[0].cpu() - ref[0]).abs().max()), float(d.abs().max()),
            float((got[2].cpu() - ref[2]).abs().max()), redid)


def test_kernel_matches_its_plain_loop_on_the_cell_pilots(handed):
    pilot, gains, state = handed
    assert tuple(pilot.shape) == (24, 240_000)
    sub, phase, freq, redid = _against_plain(pilot, gains, state.phase,
                                             state.freq)
    assert sub <= SUB and phase <= PLAIN_RAD and freq <= 1e-7, (sub, phase,
                                                                freq)
    assert redid == (0, 0)


def test_kernel_off_a_16_byte_boundary_at_an_odd_length(handed):
    pilot, gains, state = handed
    x = pilot[:, 1:1 + 48_001]
    assert x.data_ptr() % 16 != 0 and x.shape[-1] % 2 == 1
    sub, phase, freq, redid = _against_plain(x, gains, state.phase,
                                             state.freq)
    assert sub <= SUB and phase <= PLAIN_RAD and freq <= 1e-7, (sub, phase,
                                                                freq)
    assert redid == (0, 0)


def test_a_wide_loop_redoes_tiles_on_the_card_as_in_the_plain_loop(handed):
    """A 5 kHz loop: |psi| passes the series' limit, every tile is done
    again with the exact rotation on the card as in the plain loop, and
    the two still agree."""
    from radiocore_tpu_torch.kernels import nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import pll_design
    pilot, _, state = handed
    x = pilot[:4, :48_000].contiguous()
    wide = pll_design(240_000, 19e3, 5000.0)
    sub, phase, freq, redid = _against_plain(x, wide, state.phase[:4],
                                             state.freq[:4])
    assert sub <= SUB and phase <= PLAIN_RAD and freq <= 1e-7, (sub, phase,
                                                                freq)
    assert redid[0] == redid[1] == 4 * (48_000 // knco.PHASOR_TILE)


def test_graph_equals_eager_with_one_launch_and_no_tile_redone(plan):
    from radiocore_tpu_torch.kernels import nco_pll as knco
    config, pool, card = plan
    step, state = _step(config, card)
    graphed, eager = state, state
    launches = knco.launches.count
    redone = knco.redone.read(card)
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


def test_no_tile_redone_over_20_s_of_the_cell(plan):
    from radiocore_tpu_torch.kernels import nco_pll as knco
    config, pool, card = plan
    step, state = _step(config, card)
    _, state = step(pool[0], state)
    before = (knco.redone.read(card), knco.launches.count)
    steps, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < SOAK_S:
        _, state = step(pool[(steps + 1) % pool.shape[0]], state)
        steps += 1
    torch.cuda.synchronize()
    assert knco.launches.count - before[1] == steps > 1000
    assert knco.redone.read(card) == before[0]


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

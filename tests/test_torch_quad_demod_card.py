"""K-QDEMOD on the card against its plain version (the torch chain,
``kernels/quad_demod.quad_demod_plain``): on the resident band's station
IQ at 24 × 240 000 and at 8 of its rows taken from a row offset, as the
mix's groups take them; at 3 × 250 001 (the 8-byte path) and on rows off
a 16-byte boundary; at 64 × 262 144 (the power-of-two plan); dead rows of
every mix of signed zeros; NaN rows; and its launches a replayed step,
inside one graph, in an all-WBFM step and in the ``mixed24`` step.

Live samples are bit for bit, or within :data:`ATOL` where the complex
product contracts into FMAs differently; each check prints how many
samples differ. Every test here needs a CUDA card and skips without one.
This file imports no JAX, so that it runs where only the port is
installed; from the repository's root on a machine with a card:
``python3 -m pytest tests/test_torch_quad_demod_card.py -q -s
--noconftest`` (``tests/conftest.py`` sets JAX up for the CPU tests).
"""

import itertools
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.card

SEED = (1 << 31) + 2626
# A quad sample is an angle over π: one rounding of the product's parts
# moves the angle by a few float32 ulps of the phase step.
ATOL = 2.4e-7
STEPS = 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _config(name):
    with open(ROOT / f"portbench/configs/{name}.json") as f:
        return json.load(f)


def _traffic(name):
    with open(ROOT / f"portbench/traffic/{name}.json") as f:
        return json.load(f)


def _step(config, card):
    from portbench import signals
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    return make_multi_station_step(
        config["band_rate"], signals.offsets(config), config["station_rate"],
        config["audio_rate"], config["deemphasis_s"], mode=config["mode"],
        kinds=config.get("kinds"), device=card)


@pytest.fixture(scope="module")
def station_iq(card):
    """The resident band's station IQ, (24, 240 000) complex64, as the
    ``wbfm24`` step extracts it."""
    from portbench import signals
    config = _config("wbfm24_exact")
    pool = signals.band_pool(SEED, config, _traffic("resident"), card)
    step, _ = _step(config, card)
    iq = step.stages["extract"](step.stages["band_fft"](pool[0]))
    torch.cuda.synchronize()
    return iq


def _fm_rows(card, rows, n, seed):
    """FM IQ of ``rows`` rows of ``n`` points: tones at ±75 kHz of
    deviation at 240 kS/s at most, amplitude 0.5, noise 0.01 rms."""
    gen = torch.Generator(device=card).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=card)
    t = torch.arange(n, **f64) / 240_000
    tones = 100.0 + 9_000.0 * torch.rand(rows, 3, generator=gen, **f64)
    mpx = sum(torch.sin(2 * math.pi * tones[:, k:k + 1] * t)
              for k in range(3)) / 3
    phase = torch.cumsum(2 * math.pi * 75e3 / 240_000 * mpx, dim=-1)
    noise = torch.complex(torch.randn(rows, n, generator=gen, **f64),
                          torch.randn(rows, n, generator=gen, **f64))
    return (0.5 * torch.exp(1j * phase) + 0.01 * noise).to(torch.complex64)


def _against_plain(what, iq, gain=None):
    """The kernel against the plain chain on ``iq``: the number of
    differing samples and the largest gap, printed; raises above ATOL or
    where one is NaN and the other not."""
    from radiocore_tpu_torch.kernels import quad_demod as kq
    before = kq.launches.count
    got = kq.quad_demod_rows(iq, gain)
    want = kq.quad_demod_plain(iq, gain)
    torch.cuda.synchronize()
    assert kq.launches.count == before + 1
    assert got.shape == iq.shape and got.dtype == torch.float32
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    live = ~nan
    differ = int((got[live] != want[live]).sum())
    gap = float((got[live] - want[live]).abs().max()) if differ else 0.0
    print(f"[K-QDEMOD] {what}: {differ} of {int(live.sum())} samples differ "
          f"from the plain chain, max abs {gap:.3e} (bound {ATOL:.1e})")
    assert gap <= ATOL, (what, differ, gap)
    assert bool((got[..., 0] == 0).all())
    return got


@pytest.mark.parametrize("rows", [slice(0, 24), slice(8, 16)],
                         ids=["24 rows", "rows 8:16"])
def test_station_iq_of_the_resident_band(station_iq, rows):
    iq = station_iq[rows]
    _against_plain(f"resident station IQ rows {rows.start}:{rows.stop}", iq)


def test_odd_length_and_rows_off_a_16_byte_boundary(card):
    from radiocore_tpu_torch.kernels import quad_demod as kq
    iq = _fm_rows(card, 3, 250_002, seed=1)
    odd = iq[:, :250_001]
    assert not kq.vectorised(odd.data_ptr(), odd.stride(0), 3, 250_001)
    _against_plain("3 x 250 001", odd.contiguous())
    _against_plain("3 x 250 001, gain 0.5", odd.contiguous(), 0.5)
    off = iq[:, 1:250_001]
    assert not kq.vectorised(off.data_ptr(), off.stride(0), 3, 250_000)
    _against_plain("3 x 250 000 off a 16-byte boundary", off)


def test_power_of_two_plan(card):
    _against_plain("64 x 262 144", _fm_rows(card, 64, 262_144, seed=2))


def test_dead_rows_of_every_signed_zero_mix_give_zero(card):
    """Rows of zeros with every sign of both parts in every pair of
    neighbours, on the 16-byte path and off it, beside a live row."""
    from radiocore_tpu_torch.kernels import quad_demod as kq
    signs = list(itertools.product([0.0, -0.0], repeat=4))
    pairs = [complex(a, b) for a, b, _, _ in signs] + [
        complex(c, d) for _, _, c, d in signs]
    n = 4096
    rows = torch.zeros((4, n + 1), dtype=torch.complex64)
    rows[0, :len(pairs)] = torch.tensor(pairs)
    rows[1] = complex(-0.0, -0.0)
    rows[2] = torch.tensor(pairs * (-(-(n + 1) // len(pairs))))[:n + 1]
    rows[3] = _fm_rows("cpu", 1, n + 1, seed=3)[0]
    rows = rows.to(card)
    for what, iq in (("16-byte path", rows[:, :n].contiguous()),
                     ("8-byte path", rows[:, 1:])):
        got = _against_plain(f"dead rows, {what}", iq)
        assert bool((got[:3] == 0).all()), what
        assert bool((got[3, 1:] != 0).any()), what


def test_nan_stays_nan(card):
    iq = _fm_rows(card, 3, 8192, seed=4)
    iq[0, 1000] = complex(math.nan, 0.0)
    iq[1, 0] = complex(0.0, math.nan)
    iq[2] = complex(math.nan, math.nan)
    got = _against_plain("NaN rows", iq)
    assert bool(torch.isnan(got[0, 1000:1002]).all())
    assert int(torch.isnan(got[0]).sum()) == 2
    assert got[1, 0] == 0 and bool(torch.isnan(got[1, 1]))
    assert got[2, 0] == 0 and bool(torch.isnan(got[2, 1:]).all())


@pytest.mark.parametrize("name,traffic,per_step", [
    ("wbfm24_exact", "resident", 1), ("wbfm24_fast", "resident", 1),
    ("mixed24", "resident_mixed", 3)])
def test_launches_a_replayed_step(card, name, traffic, per_step):
    """One launch a step in an all-WBFM step, one a group in the mix, each
    replay counted as its capture counted, inside one graph."""
    from portbench import signals
    from radiocore_tpu_torch.kernels import quad_demod as kq
    config = _config(name)
    pool = signals.band_pool(SEED, config, _traffic(traffic), card)
    step, state = _step(config, card)
    _, state = step(pool[0], state)           # warm-up and capture
    torch.cuda.synchronize()
    before = kq.launches.count
    _, state = step(pool[1], state)
    torch.cuda.synchronize()
    assert kq.launches.count - before == per_step
    for k in range(STEPS):
        _, state = step(pool[k % 2], state)
    torch.cuda.synchronize()
    assert kq.launches.count - before == per_step * (1 + STEPS)
    assert step.graph_count == 1

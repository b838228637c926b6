"""The multi-station step with the feedback pilot loop on the card, at
the ``wbfm24_pll`` plan (24 stations of 240 kS/s on a 10 MS/s band, the
band of the ``resident_pll`` mix): the compiled step against its eager
body over chained chunks, K-NCO's launches under replay, and the ``pll``
span's event pair inside ``profiling.tracing()``.

Every test here needs a CUDA card and skips without one. This file
imports no JAX, so that it runs where only the port is installed; from
the repository's root on a machine with a card:
``python3 -m pytest tests/test_torch_pipeline_pll_card.py -q --noconftest``
(``tests/conftest.py`` sets JAX up for the CPU tests).
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.card

SEED = (1 << 31) + 4242
CHUNKS = 3


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


def _leaves(audio, state):
    return [audio, state["deemph_l"], state["deemph_r"], state["pll"].phase,
            state["pll"].freq]


def test_graph_matches_its_eager_body(plan):
    config, pool, card = plan
    step, state = _step(config, card)
    graphed, eager = state, state
    for k in range(CHUNKS):
        a_g, graphed = step(pool[k], graphed)
        a_e, eager = step.eager(pool[k], eager)
        for got, want in zip(_leaves(a_g, graphed), _leaves(a_e, eager)):
            assert torch.equal(got, want), k
    assert step.graph_count == 1


def test_one_nco_launch_a_step_under_replay(plan):
    from radiocore_tpu_torch.kernels import nco_pll
    config, pool, card = plan
    step, state = _step(config, card)
    _, state = step(pool[0], state)         # warm-up and capture
    before = nco_pll.launches.count
    for k in range(1, 1 + CHUNKS):
        _, state = step(pool[k], state)
    torch.cuda.synchronize()
    assert nco_pll.launches.count - before == CHUNKS
    assert step.graph_count == 1


def test_traced_graph_times_the_pll_span(plan, monkeypatch):
    from radiocore_tpu_torch.runtime import profiling
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    config, pool, card = plan
    step, state = _step(config, card)
    _, state = step(pool[0], state)
    with profiling.tracing():
        for k in range(1, 1 + CHUNKS):
            _, state = step(pool[k], state)
            stages = profiling.report()["stages"]
            pll = [s for s in stages if s.name == "pll"]
            tail = [s for s in stages if s.name == "demod_tail"]
            assert len(pll) == len(tail) == 1
            assert pll[0].id == tail[0].id
            assert 0 < pll[0].ms < tail[0].ms
    assert step.graph_count == 2
    assert len(rec.spans) > 0

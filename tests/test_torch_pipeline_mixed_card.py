"""The multi-station step over a mix of demodulators on the card, at the
``mixed24`` plan (24 stations of 240 kS/s on a 10 MS/s band, WBFM, MFM
and FM in rotation, the band of the ``resident`` mix): one captured
graph a step, equal to its eager body over chained chunks, one K-GATHER
launch a step, each kind's stations counted under replay, and the
groups' spans inside ``profiling.tracing()``.

Every test here needs a CUDA card and skips without one. This file
imports no JAX, so that it runs where only the port is installed; from
the repository's root on a machine with a card:
``python3 -m pytest tests/test_torch_pipeline_mixed_card.py -q
--noconftest`` (``tests/conftest.py`` sets JAX up for the CPU tests).
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

SEED = (1 << 31) + 2525
CHUNKS = 3


@pytest.fixture(scope="module")
def plan():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import signals
    with open(ROOT / "portbench/configs/mixed24.json") as f:
        config = json.load(f)
    with open(ROOT / "portbench/traffic/resident_mixed.json") as f:
        traffic = json.load(f)
    card = torch.device("cuda", 0)
    return config, signals.band_pool(SEED, config, traffic, card), card


def _step(config, card):
    from portbench import signals
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    return make_multi_station_step(
        config["band_rate"], signals.offsets(config), config["station_rate"],
        config["audio_rate"], config["deemphasis_s"], mode=config["mode"],
        kinds=config["kinds"], device=card)


def _leaves(audio, state):
    return [audio["wbfm"], audio["mfm"], audio["fm"],
            state["wbfm"]["deemph_l"], state["wbfm"]["deemph_r"],
            state["mfm"]["deemph"]]


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
    assert a_g["wbfm"].shape == (8, config["audio_rate"], 2)
    assert a_g["mfm"].shape == a_g["fm"].shape == (8, config["audio_rate"])


def test_one_gather_launch_and_each_kind_counted_under_replay(plan):
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.parallel.pipeline import demodulated
    config, pool, card = plan
    step, state = _step(config, card)
    _, state = step(pool[0], state)         # warm-up and capture
    gathers = extract.gather_launches.count
    counted = {kind: n.count for kind, n in demodulated.items()}
    for k in range(1, 1 + CHUNKS):
        _, state = step(pool[k], state)
    torch.cuda.synchronize()
    assert extract.gather_launches.count - gathers == CHUNKS
    for kind, n in demodulated.items():
        assert n.count - counted[kind] == CHUNKS * len(step.rows[kind])
    assert step.graph_count == 1


def test_traced_graph_times_each_group(plan, monkeypatch):
    from radiocore_tpu_torch.runtime import profiling
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    config, pool, card = plan
    step, state = _step(config, card)
    _, state = step(pool[0], state)
    with profiling.tracing():
        for k in range(1, 1 + CHUNKS):
            _, state = step(pool[k], state)
            stages = {s.name: s for s in profiling.report()["stages"]}
            tail = stages["demod_tail"]
            groups = [stages[f"tail_{kind}"] for kind in ("wbfm", "mfm",
                                                          "fm")]
            assert all(g.id == tail.id and 0 < g.ms for g in groups)
            assert sum(g.ms for g in groups) < tail.ms
    assert step.graph_count == 2

"""The benchmark on the CPU at a small plan (the port's plain kernel
versions), and on the card where there is one (marked ``card``)."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness, signals
from portbench.references import multi_wbfm

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
# A plan small enough for the CPU: the configurations' widths (240 kS/s
# stations, 48 kHz audio, 400 kHz apart), 4 stations on a 2 MS/s band.
SMALL = dict(stations=4, band_rate=2_000_000)
SEED = (1 << 31) + 12345
CELLS = ("wbfm24_fast.resident", "wbfm24_exact.resident",
         "wbfm24_fast.capture")
# The capture mix has no cell in BENCHMARK.json (PERF.md says why); its
# loop and readers are rehearsed under the entries that would add it.
CAPTURE = {
    "workload": {"name": "wbfm24_fast.capture", "config": "wbfm24_fast",
                 "traffic": "capture", "chips": 1},
    "end_to_end": [
        {"name": "served_channels", "unit": "channels",
         "workloads": ["wbfm24_fast.capture"]},
        {"name": "served_p95_ms", "unit": "ms",
         "workloads": ["wbfm24_fast.capture"]}],
    "per_layer": [
        {"name": name, "unit": unit, "workloads": ["wbfm24_fast.capture"]}
        for name, unit in (("source_ms.served", "ms"),
                           ("fetch_ms.served", "ms"),
                           ("between_ms.served", "ms"),
                           ("idle_share.served", "%"))],
}


def load_bench():
    """BENCHMARK.json with the capture cell's entries added."""
    b = harness.load_benchmark(ROOT)
    b["workloads"].append(CAPTURE["workload"])
    b["end_to_end"] += CAPTURE["end_to_end"]
    b["per_layer"] += CAPTURE["per_layer"]
    return b


@pytest.fixture(scope="module")
def bench():
    return load_bench()


def small_config(bench, cell):
    work = harness.find(bench["workloads"], cell, "workload")
    config = harness.load_config(ROOT, bench, work["config"])
    config.update(SMALL)
    return config


def rehearse(bench, cell, seconds=1.0):
    """One run of ``cell`` on the CPU at the small plan."""
    return harness.run_cell(ROOT, bench, cell, SEED, seconds, False, CPU,
                            time.perf_counter(),
                            config=small_config(bench, cell))


def test_parts_found_by_name(bench):
    names = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]
        for cell in m.get("workloads", []):
            harness.find(bench["workloads"], cell, "workload")
    for work in bench["workloads"]:
        config = harness.load_config(ROOT, bench, work["config"])
        assert config["name"] == work["config"]
        assert set(config["limits"]) >= {"audio_gap"}
        ref = harness.reference(config["reference"])
        assert callable(ref.answers) and callable(ref.control_step)
        traffic = harness.load_traffic(work["traffic"])
        assert callable(harness.loop(traffic["loop"]).run)
        e2e = harness.cell_metrics(bench, work["name"], False)
        layer = harness.cell_metrics(bench, work["name"], True)
        assert "setup_s" in {m["name"] for m in e2e}
        assert len(e2e) >= 2 and layer, work["name"]
    assert "setup_s" in names


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_reference_agrees_with_port(bench, mode):
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    config = small_config(bench, f"wbfm24_{mode}.resident")
    traffic = harness.load_traffic("resident")
    pool = signals.band_pool(SEED, config, traffic, CPU)
    step, state = make_multi_station_step(
        config["band_rate"], signals.offsets(config),
        config["station_rate"], config["audio_rate"], mode=mode, device=CPU)
    ref = multi_wbfm.Reference(config, device=CPU)
    first = multi_wbfm.first_answer(ref, pool[0])
    answers = multi_wbfm.answers(config, pool, CPU)
    audio, state = step(pool[0], state)
    assert harness.max_gap(audio, first["audio"]) < 1e-6
    for k in range(1, 6):
        audio, state = step(pool[k % 4], state)
        want = answers[k % 4]
        assert harness.max_gap(audio, want["audio"]) < 1e-6
        assert harness.max_gap(state["deemph_l"], want["deemph_l"]) < 1e-6
        assert harness.max_gap(state["deemph_r"], want["deemph_r"]) < 1e-6


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(bench, cell):
    """The reference one precision lower, in the port's step's place, is
    not correct by the harness's own judgement and the cell's limits."""
    with calibrate.control_in_place(small_config(bench, cell)):
        result = rehearse(bench, cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(bench, cell):
    result = rehearse(bench, cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = {m["name"] for m in harness.cell_metrics(bench, cell, False)}
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(result, allow_nan=False)


def _state_unchanged(step):
    def broken(band, state):
        audio, _ = step(band, state)
        return audio, state
    return broken


def _half_batch(step):
    def broken(band, state):
        audio, state = step(band, state)
        audio = audio.clone()
        half = audio.shape[0] // 2
        audio[half:] = audio[:half].mean(dim=0)
        return audio, state
    return broken


def _answer_altered(step):
    def broken(band, state):
        audio, state = step(band, state)
        audio = audio.clone()
        audio[1, 1000, 0] += 1e-3
        return audio, state
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_fault_is_not_correct(bench, cell, fault, monkeypatch):
    """A run whose timed step is broken underneath reads not correct."""
    from radiocore_tpu_torch.parallel import pipeline
    make = pipeline.make_multi_station_step

    def make_broken(*args, **kwargs):
        step, state = make(*args, **kwargs)
        return fault(step), state

    monkeypatch.setattr(pipeline, "make_multi_station_step", make_broken)
    result = rehearse(bench, cell)
    assert result["correct"] is False


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "radiocore_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "radiocore_tpu.fake", sys)
    assert harness.forbidden_modules() == ["radiocore_tpu"]


@pytest.mark.parametrize("cell", ["wbfm24_fast.resident",
                                  "wbfm24_fast.capture"])
def test_no_jax_after_rehearsal(cell):
    """A fresh process that rehearses a traffic mix has loaded neither JAX
    nor the JAX package, top-level names compared whole."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        "from portbench.tests import test_portbench as t\n"
        "b = t.load_bench()\n"
        f"r = t.rehearse(b, {cell!r})\n"
        "assert r['correct'], r\n"
        "assert 'radiocore_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_benchmark(
    ROOT)["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_card(cell, trace):
    """``run.py`` on the card, short window: a result line, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def test_run_refuses_without_card():
    """Without a card ``run.py`` prints no result and exits non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

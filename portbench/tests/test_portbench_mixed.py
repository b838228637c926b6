"""The cell ``mixed24.resident_mixed`` on the CPU at a small plan: the
harness's verdict on the port, on the control and on broken steps, its
entries, and the reader of ``mono_tail_ms.card``.

The plan keeps a station rate that carries the 38 kHz subcarrier
(100 kS/s) and the server's rotation of kinds over 6 stations."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness
from portbench.references import multi_mixed

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "mixed24.resident_mixed"
SMALL = dict(stations=6, station_rate=100_000, channel_spacing=100_000,
             band_rate=800_000, audio_rate=20_000,
             kinds=["wbfm", "mfm", "fm"] * 2)
SEED = (1 << 31) + 2525

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def small_config(bench):
    work = harness.find(bench["workloads"], CELL, "workload")
    config = harness.load_config(ROOT, bench, work["config"])
    config.update(SMALL)
    return config


def rehearse(bench):
    return harness.run_cell(ROOT, bench, CELL, SEED, 1.0, False, CPU,
                            time.perf_counter(), config=small_config(bench))


def test_cell_entries(bench):
    work = harness.find(bench["workloads"], CELL, "workload")
    assert work["chips"] == 1
    config = harness.load_config(ROOT, bench, work["config"])
    assert (config["mode"], config["extract_demod"]) == ("exact", "off")
    assert config["kinds"] == ["wbfm", "mfm", "fm"] * 8
    assert config["reference"] == "multi_mixed"
    assert harness.load_traffic(work["traffic"]) == dict(
        harness.load_traffic("resident"), loop="resident_mixed")
    layer = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert layer == {"band_fft_roofline", "extract_roofline", "tail_ms.card",
                     "enqueue_ms.card", "idle_share.card",
                     "mono_tail_ms.card"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} == {
        "card_channels", "setup_s"}


def test_result_line(bench):
    result = rehearse(bench)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"card_channels", "setup_s"}
    assert set(result["checks"]) == {"audio_gap", "state_gap"}
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]


def test_control_fails(bench):
    """The reference one precision lower in the port's step's place, its
    histories carried, is not correct by the cell's limits."""
    with calibrate.control_in_place(small_config(bench)):
        result = rehearse(bench)
    assert result["correct"] is False
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


def _state_unchanged(step):
    def broken(band, state):
        audio, _ = step(band, state)
        return audio, state
    return broken


def _half_batch(step):
    """Half of each kind's stations replaced by the mean of the rest."""
    def broken(band, state):
        audio, state = step(band, state)
        audio = {k: a.clone() for k, a in audio.items()}
        for a in audio.values():
            half = a.shape[0] // 2
            a[half:] = a[:half].mean(dim=0)
        return audio, state
    return broken


def _answer_altered(step):
    """One sample of one mono station altered by 1e-3."""
    def broken(band, state):
        audio, state = step(band, state)
        audio = {k: a.clone() for k, a in audio.items()}
        audio["fm"][1, 1000] += 1e-3
        return audio, state
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_fault_is_not_correct(bench, fault, monkeypatch):
    from radiocore_tpu_torch.parallel import pipeline
    make = pipeline.make_multi_station_step

    def make_broken(*args, **kwargs):
        step, state = make(*args, **kwargs)
        return fault(step), state

    monkeypatch.setattr(pipeline, "make_multi_station_step", make_broken)
    assert rehearse(bench)["correct"] is False


def test_layout_leaves_out_empty_groups():
    audio = {"fm": torch.ones(2, 5)}
    out = multi_mixed.layout(audio, None, None, torch.zeros(0, 50))
    assert set(out) == {"audio"} and out["audio"].shape == (10,)
    out = multi_mixed.layout({"wbfm": torch.ones(1, 5, 2),
                              "mfm": torch.zeros(2, 5)},
                             torch.ones(1, 50), 2 * torch.ones(1, 50),
                             torch.zeros(2, 50))
    assert out["audio"].tolist() == [1.0] * 10 + [0.0] * 10
    assert out["deemph_l"].shape == (3, 50)
    assert torch.equal(out["deemph_r"], 2 * torch.ones(1, 50))


def test_mono_tail_reader():
    read = harness.reader("mono_tail_ms.card")
    run = {"graph_stages": {"tail_mfm": [0.10, 0.12, 0.11],
                            "tail_fm": [0.05, 0.02, 0.04],
                            "tail_wbfm": [0.5, 0.5, 0.5],
                            "demod_tail": [0.7, 0.7, 0.7]}}
    # Sums a replay: 0.15, 0.14, 0.15; their median.
    assert read(run) == pytest.approx(0.15)
    assert read({"graph_stages": {"tail_fm": [0.3, 0.1]}}) == pytest.approx(
        0.2)
    # The parent's program has no such span, and the older cells no mono
    # group: silent.
    assert read({"graph_stages": {"pll": [3.0]}}) is None
    assert read({}) is None


def test_no_jax_after_rehearsal():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        "from portbench.tests import test_portbench_mixed as t\n"
        "b = harness.load_benchmark(t.ROOT)\n"
        "r = t.rehearse(b)\n"
        "assert r['correct'], r\n"
        "assert 'radiocore_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

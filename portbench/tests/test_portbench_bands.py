"""The cell ``wbfm48_2band.resident_bands`` on the CPU at a small plan:
the harness's verdict on the port, on the control and on broken steps
(rows swapped between the bands among them), its entries, the pools,
the reference, and the readers of ``bands_fft_roofline``,
``gather_roofline`` and ``front_end_ms.bands``.

The plan keeps a station rate that carries the 38 kHz subcarrier: two
bands of 2 MS/s, 3 stations of 240 kS/s each, 400 kHz apart, band B's
plan band A's moved down 100 kHz."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import bands, calibrate, harness, roofline, roofline_bands
from portbench.references import multi_bands, multi_wbfm

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "wbfm48_2band.resident_bands"
SMALL = dict(stations=6, stations_a_band=3, band_rate=2_000_000)
SEED = (1 << 31) + 2828
H100 = "NVIDIA H100 80GB HBM3"

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def small_config(bench):
    work = harness.find(bench["workloads"], CELL, "workload")
    config = harness.load_config(ROOT, bench, work["config"])
    config.update(SMALL)
    return config


def rehearse(bench, trace=False):
    return harness.run_cell(ROOT, bench, CELL, SEED, 1.0, trace, CPU,
                            time.perf_counter(), config=small_config(bench))


def test_cell_entries(bench):
    work = harness.find(bench["workloads"], CELL, "workload")
    assert work["chips"] == 1
    config = harness.load_config(ROOT, bench, work["config"])
    assert (config["mode"], config["extract_demod"]) == ("fast", "off")
    assert (config["bands"], config["stations_a_band"],
            config["stations"]) == (2, 24, 48)
    assert config["reference"] == "multi_bands"
    assert harness.load_traffic(work["traffic"]) == dict(
        harness.load_traffic("resident"), loop="resident_bands")
    layer = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert layer == {"bands_fft_roofline", "gather_roofline",
                     "front_end_ms.bands", "extract_roofline",
                     "tail_ms.card", "enqueue_ms.card", "idle_share.card"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} == {
        "card_channels", "setup_s"}
    # The one-band share reads the batch as one band: not listed here.
    assert CELL not in next(m for m in bench["per_layer"]
                            if m["name"] == "band_fft_roofline")["workloads"]


def test_the_cells_plan():
    """The configuration's stations: band A 88.3-97.5 MHz, band B
    98.1-107.3 MHz, every other 200 kHz channel on odd tenths."""
    with open(ROOT / "portbench/configs/wbfm48_2band.json") as f:
        import json
        config = json.load(f)
    plans = bands.band_offsets(config)
    freqs = [c + o for c, offs in zip(config["band_centers_hz"], plans)
             for o in offs]
    assert freqs[0] == 88_300_000 and freqs[23] == 97_500_000
    assert freqs[24] == 98_100_000 and freqs[-1] == 107_300_000
    assert all(f % 200_000 == 100_000 for f in freqs)
    assert all(b - a == 400_000 for a, b in zip(freqs, freqs[1:24]))
    assert all(b - a == 400_000 for a, b in zip(freqs[24:], freqs[25:]))
    assert plans[1] == [o - 100_000 for o in plans[0]]


def test_offsets_refuse_a_plan_that_does_not_fit(bench):
    config = small_config(bench)
    with pytest.raises(ValueError, match="leaves the band"):
        bands.band_offsets(dict(config, band_shift_hz=[0, -800_000]))
    with pytest.raises(ValueError, match="are not 6 stations"):
        bands.band_offsets(dict(config, band_shift_hz=[0]))


def test_result_line(bench):
    result = rehearse(bench)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"card_channels", "setup_s"}
    assert set(result["checks"]) == {"audio_gap", "state_gap"}


def test_reference_is_multi_wbfm_a_band(bench):
    """Each band's rows are ``multi_wbfm``'s chain on that band's chunks
    and offsets, joined band after band."""
    config = small_config(bench)
    traffic = harness.load_traffic("resident_bands")
    pool = bands.band_pools(SEED, config, traffic, CPU)
    answers = multi_bands.answers(config, pool, CPU)
    assert answers[1]["audio"].shape == (6, config["audio_rate"], 2)
    for b, offs in enumerate(bands.band_offsets(config)):
        ref = multi_wbfm.Reference(bands.one_band(config), device=CPU)
        ref.offsets = offs
        want = multi_wbfm.pool_answers(ref, pool[:, b])[1]
        for key, value in want.items():
            assert torch.equal(answers[1][key][3 * b:3 * b + 3], value)


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
        audio[4, 1000, 0] += 1e-3
        return audio, state
    return broken


def _bands_swapped(step):
    """The two bands' rows exchanged, audio and state alike."""
    def broken(band, state):
        audio, state = step(band, state)
        half = audio.shape[0] // 2
        swap = list(range(half, 2 * half)) + list(range(half))
        return audio[swap], {k: v[swap] for k, v in state.items()}
    return broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered, _bands_swapped])
def test_fault_is_not_correct(bench, fault, monkeypatch):
    from radiocore_tpu_torch.parallel import pipeline
    make = pipeline.make_multi_station_step

    def make_broken(*args, **kwargs):
        step, state = make(*args, **kwargs)
        return fault(step), state

    monkeypatch.setattr(pipeline, "make_multi_station_step", make_broken)
    assert rehearse(bench)["correct"] is False


def test_the_loop_counts_bands_and_gathers(bench):
    """The record of a run: the bands stepped a step from the port's
    counter; K-GATHER launches none on the CPU."""
    config = small_config(bench)
    traffic = harness.load_traffic("resident_bands")
    loop = harness.loop("resident_bands")
    record = loop.run(config, traffic, SEED, 0.5, False, CPU,
                      time.perf_counter())
    assert record["loop"] == "resident" and record["stations"] == 6
    assert record["bands_a_step"] == 2.0
    assert record["gather_launches_a_step"] == 0.0
    assert record["pool"]().shape == (4, 2, config["band_rate"])
    for out in record["outputs"]:
        assert out["audio"].shape == (6, config["audio_rate"], 2)
        assert out["deemph_l"].shape == (6, 50)


def test_bands_fft_reader(bench):
    config = dict(small_config(bench), band_rate=10_000_000)
    read = harness.reader("bands_fft_roofline")
    one = roofline.band_fft_bound_ms(config, H100)
    run = {"stage_ms": {"band_fft": 2 * one / 0.25}, "config": config,
           "device_name": H100}
    assert read(run) == pytest.approx(25.0)
    assert roofline_bands.bands_fft_bound_ms(config, H100) == 2 * one
    # Below one read and write of both bands: refused.
    floor = 2 * 2 * 10_000_000 * 8 / 3.35e12 * 1e3
    with pytest.raises(roofline.BelowFloor):
        read(dict(run, stage_ms={"band_fft": 0.9 * floor}))
    # A configuration of one band, or no stage time: silent.
    one_band = {k: v for k, v in config.items() if k != "bands"}
    assert read(dict(run, config=one_band)) is None
    assert read(dict(run, stage_ms={})) is None


def test_gather_reader(bench):
    config = dict(small_config(bench), stations=48, station_rate=240_000)
    read = harness.reader("gather_roofline")
    bound = roofline_bands.gather_bound_ms(config, H100)
    assert bound == pytest.approx(2 * 48 * 240_000 * 8 / 3.35e12 * 1e3)
    run = {"gather_ms_a_step": bound / 0.8, "gather_launches_a_step": 1.0,
           "config": config, "device_name": H100}
    assert read(run) == pytest.approx(80.0)
    assert read(dict(run, gather_launches_a_step=2.0)) == pytest.approx(
        160.0)
    # No kernel time (a CPU run, or a program without K-GATHER): silent.
    assert read(dict(run, gather_ms_a_step=0.0)) is None
    assert read({"config": config, "device_name": H100}) is None


def test_front_end_reader():
    read = harness.reader("front_end_ms.bands")
    run = {"graph_stages": {"band_fft": [0.40, 0.42, 0.41],
                            "extract": [0.30, 0.20, 0.32],
                            "demod_tail": [0.7, 0.7, 0.7]}}
    # Sums a replay: 0.70, 0.62, 0.73; their median.
    assert read(run) == pytest.approx(0.70)
    assert read({"graph_stages": {"band_fft": [0.4]}}) is None
    assert read({}) is None


def test_no_jax_after_rehearsal():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        "from portbench.tests import test_portbench_bands as t\n"
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

"""The cell ``wbfm24_pll.resident_pll`` on the CPU at a small plan: the
harness's verdict on the port, on the control and on broken steps; the
band of its mix; its loop's readers.

The plan keeps a station rate that carries the 38 kHz subcarrier
(100 kS/s) and 4 stations; the loop's plain version runs one Python
iteration a sample, so the rehearsals shorten the warm-up to the two
steps a locked answer needs (a step from the initial state, then one
from a locked loop, whose legs give the next step its history)."""

import math
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness, pilots, roofline_serial
from portbench.loops import resident_pll
from portbench.references import multi_wbfm_pll
from portbench.tests.test_portbench import (_answer_altered, _half_batch,
                                            _state_unchanged)

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
CELL = "wbfm24_pll.resident_pll"
SMALL = dict(stations=4, station_rate=100_000, channel_spacing=100_000,
             band_rate=500_000, audio_rate=20_000)
SEED = (1 << 31) + 12345
WARMUP = 2

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def small_config(bench):
    work = harness.find(bench["workloads"], CELL, "workload")
    config = harness.load_config(ROOT, bench, work["config"])
    config.update(SMALL)
    return config


def rehearse(bench, monkeypatch):
    monkeypatch.setattr(resident_pll, "WARMUP_STEPS", WARMUP)
    return harness.run_cell(ROOT, bench, CELL, SEED, 1.0, False, CPU,
                            time.perf_counter(), config=small_config(bench))


def test_cell_entries(bench):
    work = harness.find(bench["workloads"], CELL, "workload")
    assert work["chips"] == 1
    config = harness.load_config(ROOT, bench, work["config"])
    assert (config["mode"], config["pll"], config["extract_demod"]) == (
        "exact", "nco", "off")
    assert config["reference"] == "multi_wbfm_pll"
    assert harness.load_traffic(work["traffic"])["loop"] == "resident_pll"
    layer = {m["name"] for m in harness.cell_metrics(bench, CELL, True)}
    assert layer == {"band_fft_roofline", "extract_roofline", "tail_ms.card",
                     "enqueue_ms.card", "idle_share.card", "pll_ms.card",
                     "nco_roofline"}
    assert {m["name"] for m in harness.cell_metrics(bench, CELL, False)} == {
        "card_channels", "setup_s"}


def test_result_line(bench, monkeypatch):
    result = rehearse(bench, monkeypatch)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"card_channels", "setup_s"}
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]


def test_control_fails(bench, monkeypatch):
    """The reference one precision lower in the port's step's place, its
    loop state carried, is not correct by the cell's limits."""
    with calibrate.control_in_place(small_config(bench)):
        result = rehearse(bench, monkeypatch)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_fault_is_not_correct(bench, fault, monkeypatch):
    from radiocore_tpu_torch.parallel import pipeline
    make = pipeline.make_multi_station_step

    def make_broken(*args, **kwargs):
        step, state = make(*args, **kwargs)
        return fault(step), state

    monkeypatch.setattr(pipeline, "make_multi_station_step", make_broken)
    assert rehearse(bench, monkeypatch)["correct"] is False


def _station_iq(pool, config, s):
    """Station ``s``'s IQ over the whole pool, cut from the pool's
    spectrum at its bins (no window): the FM signal the pool was made
    from, plus the noise in its bins."""
    chunks, n = pool.shape
    sc = int(config["station_rate"])
    spec = torch.fft.fft(pool.reshape(-1).to(torch.complex128))
    k = torch.fft.fftfreq(chunks * sc, 1.0 / (chunks * sc)).long()
    off = pilots.signals.offsets(config)[s]
    return torch.fft.ifft(spec[(chunks * off + k) % (chunks * n)])


def test_pilots_join_at_the_wrap(bench):
    """Each station's pilot has whole periods in the pool, at the drawn
    frequency and phase: its phase, read from every chunk's demodulated
    IQ against the pool's own clock, is the same in each chunk, so the
    last chunk runs on into the first without a step."""
    config = small_config(bench)
    traffic = harness.load_traffic("resident_pll")
    pool = pilots.band_pool(SEED, config, traffic, CPU)
    chunks, sc = pool.shape[0], int(config["station_rate"])
    _, _, freq, phase = pilots.draws(SEED, config, traffic, CPU)
    assert torch.all((freq - pilots.PILOT_HZ).abs() <= 2.0)
    assert torch.all(freq * chunks == torch.round(freq * chunks))
    assert len(set(freq.tolist())) > 1
    t = torch.arange(chunks * sc, dtype=torch.float64) / sc
    for s in range(config["stations"]):
        iq = _station_iq(pool, config, s)
        quad = torch.angle(iq * torch.conj(torch.roll(iq, 1)))  # wraps too
        proj = (quad * torch.exp(-2j * math.pi * freq[s] * t)).reshape(
            chunks, sc).sum(dim=-1)
        got = torch.angle(proj * 1j)     # sin(theta) projects to -j e^{j phi}
        step = torch.angle(torch.exp(1j * (got - got.roll(1))))
        assert float(step.abs().max()) < 1e-2, (s, got)
        drawn = torch.angle(torch.exp(1j * (got - phase[s])))
        assert float(drawn.abs().max()) < 2e-2, (s, got, phase[s])


def test_loop_forgets_its_start(bench):
    """Run over one chunk from two loop states, the reference's loop
    agrees with itself within 1e-9 rad over the chunk's last quarter: a
    one-second lead-in leaves no trace of where the loop started."""
    config = small_config(bench)
    traffic = harness.load_traffic("resident_pll")
    pool = pilots.band_pool(SEED, config, traffic, CPU)
    ref = multi_wbfm_pll.Reference(config, device=CPU)
    _, x = ref.front(pool[0])
    a, ph, fr = ref.track(x, *ref.initial_loop(x.shape[0]))
    b, _, _ = ref.track(x, ph + 1.0, fr)
    d = torch.angle(torch.exp(1j * (a - b))).abs()
    quarter = x.shape[-1] // 4
    assert float(d[:, -quarter:].max()) < 1e-9
    assert float(d[:, :100].max()) > 0.1


def test_readers():
    config = {"stations": 24, "station_rate": 240_000}
    card = "NVIDIA H100 80GB HBM3"
    floor = roofline_serial.nco_floor_ms(config, card)
    assert floor == pytest.approx(240_000 * 4 / 1.98e9 * 1e3)
    run = {"config": config, "device_name": card, "nco_ms_a_step": 4.0,
           "nco_launches_a_step": 1.0,
           "graph_stages": {"pll": [4.2, 4.0, 4.1], "demod_tail": [5.0]}}
    nco = harness.reader("nco_roofline")
    pll = harness.reader("pll_ms.card")
    assert nco(run) == pytest.approx(100 * floor / 4.0)
    assert pll(run) == pytest.approx(4.1)
    # The parent's program has no span and launches no K-NCO: silent.
    quiet = {"config": config, "device_name": card, "nco_ms_a_step": 0.0,
             "nco_launches_a_step": 0.0, "graph_stages": {}}
    assert nco(quiet) is None and pll(quiet) is None
    assert nco({}) is None and pll({}) is None


def test_kernel_seconds_between_the_marks():
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, a, b):
        return types.SimpleNamespace(
            name=name, device_type=cuda,
            time_range=types.SimpleNamespace(start=a, end=b))

    events = [ev("rc::nco_pll_kernel(rc::NcoPll)", 0, 50),
              ev("Histogram kernel", 100, 110),
              ev("rc::nco_pll_kernel(rc::NcoPll)", 120, 170),
              ev("fft", 170, 180),
              ev("rc::nco_pll_kernel(rc::NcoPll)", 190, 240),
              ev("Histogram kernel", 230, 235),
              ev("rc::nco_pll_kernel(rc::NcoPll)", 300, 350)]
    got = resident_pll.kernel_seconds(events, resident_pll.NCO_KERNEL)
    assert got == pytest.approx((50 + 40) * 1e-6)
    assert resident_pll.kernel_seconds(events[:3], "nco_pll_kernel") == 0.0


def test_no_jax_after_rehearsal():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness\n"
        "from portbench.loops import resident_pll\n"
        "from portbench.tests import test_portbench_pll as t\n"
        f"resident_pll.WARMUP_STEPS = {WARMUP}\n"
        "b = harness.load_benchmark(t.ROOT)\n"
        "r = harness.run_cell(t.ROOT, b, t.CELL, t.SEED, 1.0, False, t.CPU,\n"
        "                     time.perf_counter(), config=t.small_config(b))\n"
        "assert r['correct'], r\n"
        "assert 'radiocore_tpu_torch' in sys.modules\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

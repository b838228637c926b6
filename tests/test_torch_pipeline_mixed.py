"""The multi-station step over a mix of demodulators
(``make_multi_station_step(kinds=...)``) on the CPU: held over chained
chunks to the float64 reference of the benchmark
(``portbench/references/multi_mixed.py``, which imports nothing of the
port), each group against its kind's own step, the all-WBFM step left as
it was, the invalid combinations, ``step.rows``, the groups' spans and
counters, and ``serve_fused`` and the server's ``--fused`` over the mix.

The plan is small but keeps a station rate that carries the 38 kHz
subcarrier: 6 stations of 100 kS/s in the server's rotation (WBFM, MFM,
FM, WBFM, MFM, FM), 100 kHz apart on an 800 kS/s band, 20 kHz audio, the
band of the ``resident`` mix (``portbench/signals.py``)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import signals  # noqa: E402
from portbench.references import multi_mixed  # noqa: E402
from radiocore_tpu_torch.apps import multi_fm_server as srv  # noqa: E402
from radiocore_tpu_torch.apps.iq import SyntheticFmSource  # noqa: E402
from radiocore_tpu_torch.models.fm import make_fm_step  # noqa: E402
from radiocore_tpu_torch.models.mfm import (make_mfm_step,  # noqa: E402
                                            mfm_init_state)
from radiocore_tpu_torch.models.wbfm import (make_wbfm_step,  # noqa: E402
                                             wbfm_init_state)
from radiocore_tpu_torch.ops import fft as _fft  # noqa: E402
from radiocore_tpu_torch.ops.channelize import make_extractor  # noqa: E402
from radiocore_tpu_torch.ops.demod import quadrature_demod  # noqa: E402
from radiocore_tpu_torch.parallel import pipeline  # noqa: E402
from radiocore_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_multi_station_step)
from radiocore_tpu_torch.runtime import profiling  # noqa: E402

torch.set_num_threads(2)

KINDS = ["wbfm", "mfm", "fm"] * 2
CONFIG = dict(stations=6, channel_spacing=100_000, station_rate=100_000,
              band_rate=800_000, audio_rate=20_000, deemphasis_s=75e-6,
              precision="float32", mode="exact", extract_demod="off",
              kinds=KINDS)
TRAFFIC = dict(pool_chunks=4, tone_hz=[200, 2000], audio_amp=0.3,
               pilot_amp=0.1, deviation_gain=0.25, noise_rms=0.01)
SEED = (1 << 31) + 2525
CHUNKS = 3
# The port runs in float32 through about ten transforms of 1e5 points a
# chunk; against the float64 chain its audio (WBFM peaks ≈ 0.08, FM and
# MFM ≈ 0.2) reads ≈ 1e-7 and its carried histories under 2e-7, as the
# all-WBFM step does against ``multi_wbfm`` (portbench's tests hold that
# one at 1e-6 too). 1e-6 leaves five times that; the bfloat16 control
# reads ≈ 1e-3.
ATOL = 1e-6


def _step(kinds=KINDS, mode="exact", c=CONFIG, **kwargs):
    return make_multi_station_step(
        c["band_rate"], signals.offsets(c), c["station_rate"],
        c["audio_rate"], c["deemphasis_s"], mode=mode, kinds=kinds,
        device="cpu", **kwargs)


def _gap(got, want):
    return float((got.to(torch.float64) - want.to(torch.float64))
                 .abs().max())


@pytest.fixture(scope="module")
def pool():
    return signals.band_pool(SEED, CONFIG, TRAFFIC, "cpu")


@pytest.fixture(scope="module")
def chained(pool):
    """The port's step over ``CHUNKS`` chained chunks from its initial
    state: ``(step, [(audio, state) after each chunk])``."""
    step, state = _step()
    out = []
    for k in range(CHUNKS):
        audio, state = step(pool[k], state)
        out.append((audio, state))
    return step, out


def _reference_chain(pool, precision):
    """The reference over the same chunks from the same initial state:
    ``[(audio, histories)]`` by kind."""
    ref = multi_mixed.Reference(CONFIG, precision, device="cpu")
    hist, out = ref.initial_histories(), []
    for k in range(CHUNKS):
        audio, hist = ref.chunk(ref.groups(pool[k]), hist)
        out.append((audio, hist))
    return out


def _gaps(audio, state, want_audio, want_hist):
    """The widest audio gap and the widest history gap of one chunk."""
    a = max(_gap(audio[k], want_audio[k]) for k in ("wbfm", "mfm", "fm"))
    s = max(_gap(state["wbfm"]["deemph_l"], want_hist["wbfm"][:, 0]),
            _gap(state["wbfm"]["deemph_r"], want_hist["wbfm"][:, 1]),
            _gap(state["mfm"]["deemph"], want_hist["mfm"]))
    return a, s


def test_chained_steps_match_the_float64_reference(pool, chained):
    _, out = chained
    for k, (want_audio, want_hist) in enumerate(
            _reference_chain(pool, "float64")):
        audio, state = out[k]
        audio_gap, state_gap = _gaps(audio, state, want_audio, want_hist)
        assert audio_gap < ATOL and state_gap < ATOL, (k, audio_gap,
                                                       state_gap)


def test_the_bfloat16_control_fails_the_tolerance(pool):
    out = _reference_chain(pool, "float64")
    control = _reference_chain(pool, "bfloat16")
    for (a64, h64), (a16, h16) in zip(out, control):
        state = {"wbfm": {"deemph_l": h16["wbfm"][:, 0],
                          "deemph_r": h16["wbfm"][:, 1]},
                 "mfm": {"deemph": h16["mfm"]}}
        audio_gap, state_gap = _gaps(a16, state, a64, h64)
        assert audio_gap > 100 * ATOL and state_gap > 100 * ATOL
        for kind in ("mfm", "fm"):     # each mono group on its own too
            assert _gap(a16[kind], a64[kind]) > 100 * ATOL


def test_layout_answers_match_the_chain(pool):
    """``multi_mixed.answers`` lays out the chain: WBFM, MFM and FM audio
    flattened and joined, WBFM left then MFM histories, WBFM right."""
    ref = multi_mixed.Reference(CONFIG, device="cpu")
    groups = [ref.groups(pool[p]) for p in range(pool.shape[0])]
    answers = multi_mixed.answers(CONFIG, pool, torch.device("cpu"))
    m = CONFIG["audio_rate"]
    assert answers[1]["audio"].shape == (2 * m * 2 + 2 * m + 2 * m,)
    assert answers[1]["deemph_l"].shape == (4, 50)
    assert answers[1]["deemph_r"].shape == (2, 50)
    hist = {k: groups[0][k][..., -50:] for k in ("wbfm", "mfm")}
    audio, new = ref.chunk(groups[1], hist)
    assert torch.equal(answers[1]["audio"][:2 * m * 2],
                       audio["wbfm"].reshape(-1))
    assert torch.equal(answers[1]["audio"][-2 * m:], audio["fm"].reshape(-1))
    assert torch.equal(answers[1]["deemph_l"][2:], new["mfm"])


def _extracted(step, band):
    return step.stages["extract"](step.stages["band_fft"](band))


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_each_group_matches_its_kinds_own_step(pool, mode):
    """Each group's rows are what its kind's step gives on the same
    extracted IQ: ``make_wbfm_step`` in the step's mode, ``make_mfm_step``
    and ``make_fm_step``."""
    c = CONFIG
    sc, m = c["station_rate"], c["audio_rate"]
    step, state = _step(mode=mode)
    audio, new = step(pool[0], state)
    iq = _extracted(step, pool[0])
    rows = step.rows
    w, mf, f = (iq[0:2], iq[2:4], iq[4:6])
    if mode == "exact":
        want_w, want_ws = make_wbfm_step(sc, m)(
            w, wbfm_init_state(m, batch_shape=(2,), device="cpu"))
    else:
        want_w, want_ws = make_wbfm_step(sc, m, mode="fast")(
            w, wbfm_init_state(m, batch_shape=(2,), device="cpu"))
    want_m, want_ms = make_mfm_step(sc, m)(
        mf, mfm_init_state(m, batch_shape=(2,), device="cpu"))
    want_f = make_fm_step(sc, m)(f)
    assert rows == {"wbfm": (0, 3), "mfm": (1, 4), "fm": (2, 5)}
    assert _gap(audio["wbfm"], want_w) <= 1e-6
    assert _gap(audio["mfm"], want_m) <= 1e-6
    assert _gap(audio["fm"], want_f) <= 1e-6
    assert _gap(new["wbfm"]["deemph_l"], want_ws["deemph_l"]) <= 1e-6
    assert _gap(new["wbfm"]["deemph_r"], want_ws["deemph_r"]) <= 1e-6
    assert _gap(new["mfm"]["deemph"], want_ms["deemph"]) <= 1e-6


def test_rows_come_out_grouped_by_kind(pool):
    """The extraction's rows are the all-WBFM step's rows permuted:
    WBFM stations 0 and 3, then MFM 1 and 4, then FM 2 and 5."""
    mixed, _ = _step()
    plain, _ = _step(kinds=None)
    got = _extracted(mixed, pool[0])
    want = _extracted(plain, pool[0])
    order = [i for r in mixed.rows.values() for i in r]
    assert order == [0, 3, 1, 4, 2, 5]
    assert torch.equal(got, want[order])


def test_step_rows_of_a_partial_mix():
    step, state = _step(kinds=["fm", "fm", "mfm", "fm", "mfm", "fm"])
    assert step.rows == {"mfm": (2, 4), "fm": (0, 1, 3, 5)}
    assert set(state) == {"mfm"}
    assert state["mfm"]["deemph"].shape == (2, 50)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_all_wbfm_builds_the_default_step(pool, mode):
    """``kinds=None`` and every station ``"wbfm"`` build the all-WBFM
    step, bit for bit, and both equal the step put together from its
    parts: the band FFT, the extractor over the plan's shifts and the
    WBFM step over the station batch."""
    c = CONFIG
    sc, m = c["station_rate"], c["audio_rate"]
    default, s0 = _step(kinds=None, mode=mode)
    listed, s1 = _step(kinds=["wbfm"] * 6, mode=mode)
    assert set(default.stages) == set(listed.stages) == {
        "band_fft", "extract", "demod_tail"}
    assert not hasattr(default, "rows") and not hasattr(listed, "rows")
    extract = make_extractor(c["band_rate"],
                             [-o for o in signals.offsets(c)], sc)
    if mode == "exact":
        tail = make_wbfm_step(sc, m)
    else:
        spec_tail = make_wbfm_step(sc, m, mode="fast_spec")

        def tail(iq, state):
            return spec_tail(_fft.rfft(quadrature_demod(iq)), state)
    s2 = wbfm_init_state(m, batch_shape=(6,), device="cpu")
    for k in range(2):
        a0, s0 = default(pool[k], s0)
        a1, s1 = listed(pool[k], s1)
        a2, s2 = tail(extract(_fft.fft(pool[k])).to(torch.complex64), s2)
        for got in (a1, a2):
            assert torch.equal(a0, got)
        for got in (s1, s2):
            assert all(torch.equal(s0[key], got[key]) for key in s0)


@pytest.mark.parametrize("kwargs,match", [
    (dict(extract_demod="fused", mode="fast"), "extract_demod"),
    (dict(extract_demod="spec", mode="fast"), "extract_demod"),
    (dict(mesh=object()), "mesh"),
    (dict(kinds=KINDS[:5]), "5 kinds for 6 stations"),
    (dict(kinds=KINDS[:5] + ["am"]), "unknown kinds"),
], ids=["fused", "spec", "mesh", "length", "unknown"])
def test_invalid_combinations_raise(kwargs, match):
    c = CONFIG
    kwargs = dict(kwargs)
    kinds = kwargs.pop("kinds", KINDS)
    with pytest.raises(ValueError, match=match):
        make_multi_station_step(c["band_rate"], signals.offsets(c),
                                c["station_rate"], c["audio_rate"],
                                kinds=kinds, device="cpu", **kwargs)


def test_counters_advance_by_each_groups_rows(pool):
    step, state = _step(kinds=["wbfm", "fm", "fm", "mfm", "fm", "fm"])
    before = {k: n.count for k, n in pipeline.demodulated.items()}
    for k in range(2):
        _, state = step(pool[k], state)
    got = {k: n.count - before[k] for k, n in pipeline.demodulated.items()}
    assert got == {"wbfm": 2, "mfm": 2, "fm": 8}


def test_traced_step_records_each_groups_span(pool, monkeypatch):
    """An eager traced step opens ``tail_wbfm``, ``tail_mfm`` and
    ``tail_fm`` inside ``demod_tail``; in a profile their ranges are
    ``radiocore.tail_*``. The all-WBFM step has none."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    step, state = _step()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing():
            step(pool[0], state)
    spans = {s.name: s for s in rec.spans}
    outer = spans["demod_tail"]
    names = [f"tail_{k}" for k in ("wbfm", "mfm", "fm")]
    for name in names:
        inner = spans[name]
        assert inner.parent == "demod_tail" and inner.id == outer.id == 1
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    assert (spans["tail_wbfm"].end_ns <= spans["tail_mfm"].start_ns
            and spans["tail_mfm"].end_ns <= spans["tail_fm"].start_ns)
    events = {e.name for e in prof.events()}
    assert {f"radiocore.{n}" for n in names} <= events

    rec.spans.clear()
    step, state = _step(kinds=None)
    with profiling.tracing():
        step(pool[0], state)
    assert not {s.name for s in rec.spans} & set(names)


class _Publisher:
    def __init__(self):
        self.sent = []

    def send_multipart(self, parts):
        self.sent.append(parts)


class _Sink:
    def __init__(self):
        self.chunks = []

    def write(self, audio):
        self.chunks.append(np.array(audio))


def _specs(modes, bandwidths=None):
    bandwidths = bandwidths or [50e3] * len(modes)
    return [srv.StationSpec(96.9e6 + i * 400e3, mode, bw)
            for i, (mode, bw) in enumerate(zip(modes, bandwidths))]


def test_serve_fused_publishes_each_kinds_channels():
    """Each station under its topic with its own demodulator: a WBFM
    station two channels a sample, MFM and FM one, each the fused step's
    row for that station."""
    modes = ["wbfm", "mfm", "fm"]
    specs = _specs(modes)
    n_band, audio = 1_000_000, 10_000
    offsets = [int(s.frequency - 97.3e6) for s in specs]
    pub, sinks = _Publisher(), [_Sink() for _ in specs]
    srv.serve_fused(specs, n_band, audio,
                    SyntheticFmSource(n_band, offsets, 50_000, seed=3), 2,
                    pub, sinks, device="cpu")
    assert len(pub.sent) == 2 * len(specs)
    for k, (topic, payload) in enumerate(pub.sent):
        i = k % len(specs)
        assert topic == int(specs[i].frequency).to_bytes(4, "little")
        channels = 2 if modes[i] == "wbfm" else 1
        assert len(payload) == audio * channels * 4
        sent = np.frombuffer(payload, np.float32)
        assert np.array_equal(sent, sinks[i].chunks[k // 3].reshape(-1))
    assert [s.chunks[0].shape for s in sinks] == [(audio, 2), (audio, 1),
                                                  (audio, 1)]
    # The same rows as the fused step run directly on the same chunks.
    step, state = make_multi_station_step(n_band, offsets, 50_000, audio,
                                          mode="fast", kinds=modes,
                                          device="cpu")
    source = SyntheticFmSource(n_band, offsets, 50_000, seed=3)
    for k in range(2):
        band = torch.as_tensor(source.read_chunk(1.0)).to(torch.complex64)
        out, state = step(band, state)
        assert np.array_equal(sinks[0].chunks[k], out["wbfm"][0].numpy())
        assert np.array_equal(sinks[1].chunks[k][:, 0], out["mfm"][0].numpy())
        assert np.array_equal(sinks[2].chunks[k][:, 0], out["fm"][0].numpy())


def test_serve_fused_refuses_unequal_bandwidths():
    specs = _specs(["wbfm", "mfm"], [50e3, 100e3])
    with pytest.raises(ValueError, match="one station bandwidth"):
        srv.serve_fused(specs, 1_000_000, 10_000,
                        SyntheticFmSource(1_000_000, [-200_000, 200_000],
                                          50_000), 1, device="cpu")


def test_fused_server_serves_the_default_modes(tmp_path, capsys):
    """``--fused`` serves the Tuner path's modes: WBFM, MFM, FM."""
    from scipy.io import wavfile
    prefix = str(tmp_path / "mix")
    srv.main(["--stations", "3", "--band-rate", "1e6",
              "--bandwidth", "50e3", "--audio-rate", "10e3",
              "--seconds", "1", "--no-zmq", "--fused",
              "--wav-prefix", prefix, "--device", "cpu"])
    assert "served 1 chunks x 3 stations" in capsys.readouterr().out
    shapes = [wavfile.read(f"{prefix}_{i}.wav")[1].shape for i in range(3)]
    assert shapes == [(10_000, 2), (10_000,), (10_000,)]


@pytest.mark.parametrize("variable", ["fused", "spec"])
def test_fused_server_refuses_the_extract_demod_kernels_on_a_mix(
        variable, monkeypatch, capsys):
    """The fused extract+demod kernels decode WBFM only: ``main`` refuses
    them on the default rotation before it builds the tuner, and never
    decodes an MFM or FM station as WBFM."""
    monkeypatch.setenv("RADIOCORE_TPU_EXTRACT_DEMOD", variable)

    def no_tuner(*args, **kwargs):
        raise AssertionError("the tuner was built")

    monkeypatch.setattr(srv, "build_tuner", no_tuner)
    with pytest.raises(SystemExit) as refused:
        srv.main(["--stations", "2", "--band-rate", "1e6",
                  "--bandwidth", "50e3", "--audio-rate", "10e3",
                  "--seconds", "1", "--no-zmq", "--fused",
                  "--device", "cpu"])
    assert refused.value.code == 2
    assert "decodes WBFM only" in capsys.readouterr().err

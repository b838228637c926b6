"""The multi-station step over a batch of bands
(``make_multi_station_step(bands=...)``: receivers side by side, each
band with its own station plan) on the CPU: held over chained chunks to
the float64 reference of the benchmark
(``portbench/references/multi_bands.py``, which imports nothing of the
port) and row for row to each band's one-band step, bands with unequal
plans and station counts, the one-band step left as it was, the
refusals, ``step.band_rows``, the ``pipeline.bands`` counter, the
stage spans, K-GATHER's plain version with a plan a band, and
``serve_fused`` and the server's ``--fused --band-centers`` over two
sources.

The plan is small but keeps a station rate that carries the 38 kHz
subcarrier: two bands of 800 kS/s with 3 stations of 100 kS/s each,
100 kHz apart, band B's plan band A's moved down 50 kHz, 20 kHz audio,
the pools of the ``resident_bands`` mix (``portbench/bands.py``)."""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import bands  # noqa: E402
from portbench.references import multi_bands  # noqa: E402
from radiocore_tpu_torch.apps import multi_fm_server as srv  # noqa: E402
from radiocore_tpu_torch.apps.iq import SyntheticFmSource  # noqa: E402
from radiocore_tpu_torch.kernels import build  # noqa: E402
from radiocore_tpu_torch.kernels import extract as kx  # noqa: E402
from radiocore_tpu_torch.models.wbfm import (make_wbfm_step,  # noqa: E402
                                             wbfm_init_state)
from radiocore_tpu_torch.ops import fft as _fft  # noqa: E402
from radiocore_tpu_torch.ops.channelize import (  # noqa: E402
    make_band_extractor, make_extractor)
from radiocore_tpu_torch.ops.demod import quadrature_demod  # noqa: E402
from radiocore_tpu_torch.parallel import pipeline  # noqa: E402
from radiocore_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_multi_station_step)
from radiocore_tpu_torch.runtime import profiling  # noqa: E402

torch.set_num_threads(2)

CONFIG = dict(stations=6, bands=2, stations_a_band=3,
              band_shift_hz=[0, -50_000], channel_spacing=100_000,
              station_rate=100_000, band_rate=800_000, audio_rate=20_000,
              deemphasis_s=75e-6, precision="float32", mode="fast",
              extract_demod="off")
TRAFFIC = dict(pool_chunks=4, tone_hz=[200, 2000], audio_amp=0.3,
               pilot_amp=0.1, deviation_gain=0.25, noise_rms=0.01)
SEED = (1 << 31) + 2828
CHUNKS = 3
N, SC, AC = CONFIG["band_rate"], CONFIG["station_rate"], \
    CONFIG["audio_rate"]
# The port runs in float32 through about ten transforms of 1e5 points a
# chunk; against the float64 chain its audio (peaks ≈ 0.08) and carried
# histories read 0.8–5.8e-7 on three seeds here, as the one-band step
# does against ``multi_wbfm`` (portbench's tests hold that one at 1e-6
# too); two float32 steps over other batches part by at most 3.0e-7
# (the CPU's batched band FFT rounds apart from the unbatched one). The
# bfloat16 control reads ≈ 1e-3.
ATOL = 1e-6
SOURCE = ROOT / "radiocore_tpu_torch/csrc/extract_gather.cu"


def _offsets(config=CONFIG):
    return bands.band_offsets(config)


def _step(plans=None, mode="fast", **kwargs):
    return make_multi_station_step(N, None, SC, AC, CONFIG["deemphasis_s"],
                                   mode=mode, bands=plans or _offsets(),
                                   device="cpu", **kwargs)


def _one(offsets, mode="fast"):
    return make_multi_station_step(N, offsets, SC, AC,
                                   CONFIG["deemphasis_s"], mode=mode,
                                   device="cpu")


def _gap(got, want):
    return float((got.to(torch.float64) - want.to(torch.float64))
                 .abs().max())


@pytest.fixture(scope="module")
def pool():
    return bands.band_pools(SEED, CONFIG, TRAFFIC, "cpu")


def test_pools_differ_and_hold_each_bands_plan(pool):
    """Band A is ``signals.band_pool``'s on the symmetric plan; band B is
    that of another seed moved down 50 kHz (its plan band A's moved), so
    the two bands carry other tones."""
    from portbench import signals
    assert pool.shape == (4, 2, N)
    assert _offsets() == [[-100_000, 0, 100_000], [-150_000, -50_000,
                                                   50_000]]
    one = bands.one_band(CONFIG)
    assert torch.equal(pool[:, 0], signals.band_pool(SEED, one, TRAFFIC,
                                                     "cpu"))
    b = signals.band_pool(SEED + bands.SEED_STRIDE, one, TRAFFIC, "cpu")
    t = torch.arange(N, dtype=torch.float64) / N
    back = pool[:, 1].to(torch.complex128) * torch.polar(
        torch.ones_like(t), 2 * np.pi * 50_000 * t)
    assert _gap(back.real, b.real) < 1e-6 and _gap(back.imag, b.imag) < 1e-6
    assert _gap(pool[:, 0].real, pool[:, 1].real) > 0.1


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_step_against_float64_reference(pool, mode):
    """Chained chunks from the initial state against
    ``references/multi_bands``: audio and carried histories, every band's
    rows in band order."""
    config = dict(CONFIG, mode=mode)
    step, state = _step(mode=mode)
    answers = multi_bands.answers(config, pool, "cpu")
    first = multi_bands.first_answers(config, pool[0])
    for k in range(CHUNKS + 1):
        audio, state = step(pool[k % 4], state)
        want = first if k == 0 else answers[k % 4]
        assert audio.shape == (6, AC, 2)
        assert _gap(audio, want["audio"]) < ATOL, k
        assert _gap(state["deemph_l"], want["deemph_l"]) < ATOL, k
        assert _gap(state["deemph_r"], want["deemph_r"]) < ATOL, k


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_rows_are_each_bands_one_band_step(pool, mode):
    """Row for row against each band's own one-band step over chained
    chunks: the extraction bit for bit on the same spectra, the audio
    and state within two float32 steps' gap."""
    step, state = _step(mode=mode)
    ones = [_one(offs, mode) for offs in _offsets()]
    states = [s for _, s in ones]
    assert step.band_rows == (range(0, 3), range(3, 6))
    for k in range(CHUNKS):
        audio, state = step(pool[k], state)
        for b, ((one, _), rows) in enumerate(zip(ones, step.band_rows)):
            want, states[b] = one(pool[k, b], states[b])
            assert _gap(audio[rows.start:rows.stop], want) < ATOL, (k, b)
            for key in state:
                assert _gap(state[key][rows.start:rows.stop],
                            states[b][key]) < ATOL
    spectra = step.stages["band_fft"](pool[0])
    iq = step.stages["extract"](spectra)
    for b, ((one, _), rows) in enumerate(zip(ones, step.band_rows)):
        assert torch.equal(iq[rows.start:rows.stop],
                           one.stages["extract"](spectra[b]))


def test_bands_with_unequal_plans_and_counts(pool):
    """Band A's 3 stations on one grid, 2 of band B's on another: each
    band's rows are its own step's."""
    plans = [[-100_000, 0, 100_000], [-150_000, 50_000]]
    step, state = _step(plans)
    assert step.band_rows == (range(0, 3), range(3, 5))
    assert state["deemph_l"].shape == (5, 50)
    spectra = step.stages["band_fft"](pool[1])
    iq = step.stages["extract"](spectra)
    for b, offs in enumerate(plans):
        one, _ = _one(offs)
        rows = step.band_rows[b]
        assert torch.equal(iq[rows.start:rows.stop],
                           one.stages["extract"](spectra[b]))
    audio, _ = step(pool[1], state)
    for b, offs in enumerate(plans):
        one, s1 = _one(offs)
        want, _ = one(pool[1, b], s1)
        rows = step.band_rows[b]
        assert _gap(audio[rows.start:rows.stop], want) < ATOL


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_one_band_step_is_unchanged(pool, mode):
    """``offsets_hz`` builds the one-band step as before: its three
    stages, no ``band_rows``, and outputs bit for bit those of the step
    put together from its parts (the band FFT, the extractor over the
    plan's shifts, the WBFM step over the station batch)."""
    offs = _offsets()[0]
    step, s0 = _one(offs, mode)
    assert set(step.stages) == {"band_fft", "extract", "demod_tail"}
    assert not hasattr(step, "band_rows")
    extract = make_extractor(N, [-o for o in offs], SC)
    if mode == "exact":
        tail = make_wbfm_step(SC, AC)
    else:
        spec_tail = make_wbfm_step(SC, AC, mode="fast_spec")

        def tail(iq, state):
            return spec_tail(_fft.rfft(quadrature_demod(iq)), state)
    s1 = wbfm_init_state(AC, batch_shape=(3,), device="cpu")
    for k in range(CHUNKS):
        a0, s0 = step(pool[k, 0], s0)
        a1, s1 = tail(extract(_fft.fft(pool[k, 0])).to(torch.complex64), s1)
        assert torch.equal(a0, a1)
        assert all(torch.equal(s0[key], s1[key]) for key in s0)


def test_pll_works_per_row(pool):
    """The exact tail's feedback pilot loop over a batch of bands: each
    band's rows, audio and loop state, are its one-band step's."""
    step, state = _step(mode="exact", pll="nco")
    audio, state = step(pool[0], state)
    for b, offs in enumerate(_offsets()):
        one, s1 = make_multi_station_step(N, offs, SC, AC, mode="exact",
                                          pll="nco", device="cpu")
        want, s1 = one(pool[0, b], s1)
        rows = step.band_rows[b]
        assert _gap(audio[rows.start:rows.stop], want) < ATOL
        for got, ref in zip(state["pll"], s1["pll"]):
            assert _gap(got[rows.start:rows.stop], ref) < 1e-5


@pytest.mark.parametrize("kwargs,match", [
    (dict(offsets_hz=[0]), "offsets_hz and bands"),
    (dict(kinds=["wbfm"] * 6), "bands with kinds"),
    (dict(extract_demod="fused"), "bands with extract_demod='fused'"),
    (dict(extract_demod="spec"), "bands with extract_demod='spec'"),
    (dict(mesh=object()), "bands with a mesh"),
    (dict(bands=[[0, 100_000], []]), "every band needs a station"),
    (dict(bands=[[0], [360_000]]), "band 1: the station at 360000 Hz "
                                   "leaves its band"),
    (dict(bands=None), "no stations"),
], ids=["offsets", "kinds", "fused", "spec", "mesh", "empty", "outside",
        "none"])
def test_invalid_combinations_raise(kwargs, match):
    kwargs = dict(kwargs)
    offsets = kwargs.pop("offsets_hz", None)
    plans = kwargs.pop("bands", _offsets())
    mode = "fast"
    with pytest.raises(ValueError, match=re.escape(match)):
        make_multi_station_step(N, offsets, SC, AC, mode=mode, bands=plans,
                                device="cpu", **kwargs)


@pytest.mark.parametrize("shape", [(N,), (1, N), (3, N), (2, N // 2)],
                         ids=["one", "too few", "too many", "short"])
def test_a_wrong_shaped_batch_raises(shape):
    step, state = _step()
    with pytest.raises(ValueError, match="the step takes 2 bands"):
        step(torch.zeros(shape, dtype=torch.complex64), state)


def test_counter_advances_by_the_bands_a_call(pool):
    step, state = _step()
    one, s1 = _one(_offsets()[0])
    before = pipeline.bands.count
    for k in range(3):
        _, state = step(pool[k], state)
    assert pipeline.bands.count - before == 6
    _, s1 = one(pool[0, 0], s1)
    assert pipeline.bands.count - before == 7


def test_traced_step_spans_cover_the_batch(pool, monkeypatch):
    """An eager traced step opens one ``band_fft``, ``extract`` and
    ``demod_tail`` span a call, each over every band."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    step, state = _step()
    with profiling.tracing():
        step(pool[0], state)
    names = [s.name for s in rec.spans]
    assert names.count("band_fft") == names.count("extract") == 1
    assert names.count("demod_tail") == 1


@pytest.mark.parametrize("m", [9, 10, 100_000])
def test_plain_gather_rows_are_the_one_plan_gathers(m):
    """K-GATHER's plain version with a plan a band: each row bit for bit
    what the one-plan gather writes for its band alone, an odd m and an
    even one (the fix bin) included."""
    gen = torch.Generator().manual_seed(m)
    n = 800_000 if m > 100 else 64
    spectra = torch.complex(torch.randn(2, n, generator=gen),
                            torch.randn(2, n, generator=gen))
    starts = [[3, n - 5, n // 2], [0, 17 % n, n - 1]]
    window = torch.rand(m, generator=gen)
    fix = None if m % 2 else 0.25
    at = torch.tensor([b * n + a for b, s in enumerate(starts) for a in s])
    got = kx.extract_gather_rows(spectra, at, window, fix)
    assert got.shape == (6, m)
    for b, s in enumerate(starts):
        want = kx.extract_gather(spectra[b], torch.tensor(s), window, fix)
        assert torch.equal(got[3 * b:3 * b + 3], want)


def test_band_extractor_joins_each_bands_rows(pool):
    plans = [[-o for o in offs] for offs in _offsets()]
    ex = make_band_extractor(N, plans, SC)
    spectra = _fft.fft(pool[0])
    got = ex(spectra)
    want = torch.cat([make_extractor(N, p, SC)(spectra[b])
                      for b, p in enumerate(plans)])
    assert torch.equal(got, want)
    gathered = ex.gather(spectra)
    for b, e in enumerate(ex.by_band):
        assert torch.equal(gathered[3 * b:3 * b + 3], e.gather(spectra[b]))
    with pytest.raises(ValueError, match="a batch of 2 bands"):
        ex(spectra[0])


class _CudaLike:
    """What the band extractor's route reads of a batch on the card:
    device, dtype and each band's spectrum."""
    is_cuda, dtype = True, torch.complex64

    def __init__(self, dims=2):
        self.dims = dims

    def dim(self):
        return self.dims

    def __getitem__(self, b):
        return _CudaLike(1)


@pytest.mark.parametrize("impl,pow2,route", [
    ("auto", False, True), ("fused", False, True),
    ("auto", True, False), ("fused", True, False),
    ("native", False, False), ("fourstep", False, False),
])
def test_band_extractor_route_on_the_card(impl, pow2, route):
    """Which route a complex64 batch on the card takes: one K-GATHER
    launch over every band where no band's plan is K-EXTRACT's (the
    cell's 240 000-point stations), each band's own extractor where one
    is (a uniform power-of-two plan goes to K-EXTRACT, as it does alone)
    and on the torch routes."""
    from radiocore_tpu_torch.runtime import Routes
    n, m = (8192, 512) if pow2 else (N, SC)
    plan_a = [-(2 * i - 3) * m // 2 for i in range(4)] if pow2 else \
        [-o for o in _offsets()[0]]
    plans = [plan_a, [-o for o in (_offsets()[1] if not pow2 else
                                   [-1500, 0, 2600])]]
    ex = make_band_extractor(n, plans, m, Routes(extract_ifft=impl))
    assert ex.by_band[0].kernel_ok(_CudaLike(1)) == (
        pow2 and impl in ("auto", "fused"))
    assert ex.gather_route(_CudaLike()) == route


def test_gather_rows_refusals():
    spectra = torch.zeros(2, 64, dtype=torch.complex64)
    window = torch.ones(10)
    with pytest.raises(ValueError, match="spectra must be"):
        kx.extract_gather_rows(spectra[0], torch.tensor([0]), window, 0.5)
    with pytest.raises(ValueError, match="an even m takes a fix"):
        kx.extract_gather_rows(spectra, torch.tensor([0]), window)
    with pytest.raises(ValueError, match="do not fit"):
        kx.extract_gather_rows(spectra, torch.tensor([0]), torch.ones(64),
                               0.5)


def test_the_c_entry_is_the_ctypes_signature():
    params = re.search(r'extern "C" int rc_extract_gather\(([^)]*)\)',
                       SOURCE.read_text()).group(1)
    decls = [" ".join(p.split()) for p in params.split(",")]
    kinds = {"void*": build._P, "long long": build._L, "int": build._I,
             "float": build._F}
    types = [kinds[" ".join(d.replace("const ", "").split()[:-1])]
             for d in decls]
    names = [d.split()[-1].lstrip("*") for d in decls]
    assert types == build._SIGNATURES["rc_extract_gather"]
    assert names == ["spectra", "out", "at", "win", "n", "rows", "m", "fix",
                     "stream"]


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


CENTERS = [92.9e6, 93.9e6]
SERVE_BAND, SERVE_SC, SERVE_AUDIO = 1_000_000, 50_000, 10_000
PLANS = [[-200_000, 0, 200_000], [-300_000, 100_000]]


def _serve_specs():
    return [srv.StationSpec(c + o, "wbfm", SERVE_SC)
            for c, offs in zip(CENTERS, PLANS) for o in offs]


def _sources():
    return [SyntheticFmSource(SERVE_BAND, offs, SERVE_SC, seed=b)
            for b, offs in enumerate(PLANS)]


def test_serve_fused_over_two_sources():
    """Every station of both bands under its own topic, each the batched
    step's row for it on the same chunks; the specs given in any order."""
    specs = _serve_specs()
    order = [3, 0, 4, 1, 2]
    specs = [specs[i] for i in order]
    pub, sinks = _Publisher(), [_Sink() for _ in specs]
    srv.serve_fused(specs, SERVE_BAND, SERVE_AUDIO, _sources(), 2, pub,
                    sinks, device="cpu", centers=CENTERS)
    assert len(pub.sent) == 2 * len(specs)
    assert [t for t, _ in pub.sent[:5]] == [
        int(s.frequency).to_bytes(4, "little") for s in specs]
    step, state = make_multi_station_step(SERVE_BAND, None, SERVE_SC,
                                          SERVE_AUDIO, mode="fast",
                                          bands=PLANS, device="cpu")
    sources = _sources()
    for k in range(2):
        chunk = np.stack([s.read_chunk(1.0) for s in sources])
        audio, state = step(torch.as_tensor(chunk), state)
        for i, row in enumerate(order):
            assert np.array_equal(sinks[i].chunks[k], audio[row].numpy())
            sent = np.frombuffer(pub.sent[5 * k + i][1], np.float32)
            assert np.array_equal(sent, audio[row].numpy().reshape(-1))


def test_serve_fused_publishes_48_topics():
    """Two full bands of 24 stations each, as the ``wbfm48_2band`` cell's
    (here 50 kS/s stations 50 kHz apart on 1.25 MS/s bands): 48 topics a
    chunk, each station's own frequency, in the order of the specs."""
    n_band, sc = 1_250_000, 50_000
    plan = [(2 * i - 23) * 25_000 for i in range(24)]
    centers = [92.9e6, 94.2e6]
    specs = [srv.StationSpec(c + o, "wbfm", sc) for c in centers
             for o in plan]
    pub = _Publisher()
    srv.serve_fused(specs, n_band, SERVE_AUDIO,
                    [SyntheticFmSource(n_band, plan, sc, seed=b)
                     for b in range(2)], 1, pub, device="cpu",
                    centers=centers)
    topics = [t for t, _ in pub.sent]
    assert len(set(topics)) == 48
    assert topics == [int(s.frequency).to_bytes(4, "little") for s in specs]
    assert all(len(a) == SERVE_AUDIO * 2 * 4 for _, a in pub.sent)


class _Short:
    """A source whose chunks come one sample short."""

    def __init__(self, source):
        self.source = source

    def read_chunk(self, seconds=1.0):
        return self.source.read_chunk(seconds)[:-1]


def _refused(case):
    specs = _serve_specs()
    sources = _sources()
    if case == "rate":
        return dict(rate=2 * SERVE_BAND)
    if case == "source rate":
        return dict(source=[sources[0], SyntheticFmSource(
            2 * SERVE_BAND, [0], SERVE_SC)])
    if case == "leaves":
        return dict(these=specs + [srv.StationSpec(CENTERS[1] + 480e3,
                                                   "wbfm", SERVE_SC)])
    if case == "empty":
        return dict(these=specs[:3])
    if case == "short":
        return dict(source=[sources[0], _Short(sources[1])])
    if case == "count":
        return dict(source=sources[:1])
    return dict(these=specs[:-1] + [srv.StationSpec(specs[-1].frequency,
                                                    "mfm", SERVE_SC)])


@pytest.mark.parametrize("case,match", [
    ("rate", "bands of unequal rate"),
    ("source rate", "bands of unequal rate"),
    ("leaves", "leaves its band"),
    ("empty", "every band needs a station"),
    ("short", "fell out of step"),
    ("count", "1 sources for 2 bands"),
    ("mfm", "decodes WBFM only"),
])
def test_serve_fused_refusals(case, match):
    """``serve_fused`` over bands refuses a rate that is not every
    source's, a station that leaves its band, a band with no station, a
    source out of step, a source too few and a station that is not
    WBFM."""
    kw = dict(source=_sources(), rate=SERVE_BAND, these=_serve_specs())
    kw.update(_refused(case))
    with pytest.raises(ValueError, match=match):
        srv.serve_fused(kw["these"], kw["rate"], SERVE_AUDIO, kw["source"],
                        1, device="cpu", centers=CENTERS)


def test_fused_server_serves_bands(tmp_path, capsys):
    """``--fused --band-centers`` serves ``--stations`` WBFM stations a
    band, each band from its own source, one file a station."""
    from scipy.io import wavfile
    prefix = str(tmp_path / "bands")
    srv.main(["--stations", "2", "--band-rate", "1e6", "--bandwidth", "50e3",
              "--audio-rate", "10e3", "--seconds", "1", "--no-zmq",
              "--fused", "--band-centers", "92.9e6,93.9e6",
              "--wav-prefix", prefix, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "bands: 2 of 1000000 S/s centred at 92.9000, 93.9000 MHz" in out
    assert "served 1 chunks x 4 stations" in out
    shapes = [wavfile.read(f"{prefix}_{i}.wav")[1].shape for i in range(4)]
    assert shapes == [(10_000, 2)] * 4


def test_band_centers_need_fused():
    with pytest.raises(SystemExit):
        srv.main(["--band-centers", "92.9e6,93.9e6", "--no-zmq",
                  "--device", "cpu"])

"""Compiled steps (``runtime/graphs``), the port's counterpart of the JAX
package's ``jax.jit``, on the CPU.

A CUDA graph exists only on a card, so the graph path is driven through
:class:`StubGraphs`, which stands in for ``torch.cuda.CUDAGraph``: its
capture runs the step once and keeps its outputs, its replay runs the
step again on the static inputs and writes the results into those same
output tensors, and, as a real replay, goes around the launch counters.
That holds the contract around the graph (copy-in, clone-out, one graph
per signature, the counters' deltas, the keep-list); the graph itself is
held on the card by ``chip_smoke.py`` ``[graphs]``. On the CPU a
compiled step is its eager function, held here to the JAX package at the
bound of ``tests/test_torch_pipeline.py`` and ``test_torch_models.py``
(4e-5)."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracles
from radiocore_tpu_torch.kernels.fft_rows import COUNTERS, LaunchCounter
from radiocore_tpu_torch.runtime import graphs

torch.set_num_threads(2)

ATOL = 4e-5
# A plan of tests/test_torch_pipeline.py (its legacy tail) and the
# model tests' one-second convention.
PLAN = (4, 65_536, 16_384)
FS, AUDIO = 100_000, 20_000


class FakeEvent:
    """A timing event on a clock that each record advances by one."""

    now = 0.0

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        FakeEvent.now += 1.0
        self.t = FakeEvent.now

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        if self.t is None or other.t is None:
            raise RuntimeError("event not recorded")
        return other.t - self.t


class StubGraphs:
    """Stands in for :class:`runtime.graphs.CudaGraphs` on the CPU; its
    timing events are :class:`FakeEvent`, and a replay takes ten units of
    their clock."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def warm_up(self, run, times):
        for _ in range(times):
            run()

    def capture(self, run):
        self.captures += 1
        out = run()
        return (run, out), out

    def replay(self, graph):
        run, out = graph
        self.replays += 1
        FakeEvent.now += 10.0
        counts = graphs.launch_counts()
        new = run()
        graphs._set_counts(counts)
        kept, fresh = [], []
        graphs._flatten(out, kept)
        graphs._flatten(new, fresh)
        for k, f in zip(kept, fresh):
            if isinstance(k, torch.Tensor):
                k.copy_(f)

    @staticmethod
    def timing_event():
        return FakeEvent()


def _stub_step(fn):
    stub = StubGraphs()
    return graphs.Step(fn, torch.device("cpu"), stub), stub


def _offsets(c, sc):
    half = c * sc // 2 - sc // 2
    return [int(-half + i * sc) for i in range(c)]


def _fm_band(rng, c, sc):
    """Band chunk with one FM stereo station per slot plus noise (the
    bands of tests/test_torch_pipeline.py)."""
    n = c * sc
    spec = np.zeros(n, np.complex128)
    k = (np.fft.fftfreq(sc) * sc).astype(np.int64)
    for i, off in enumerate(_offsets(c, sc)):
        mpx = oracles.make_stereo_multiplex(sc, sc, 300.0 + 200 * i,
                                            1100.0 + 300 * i)
        spec[(off + k) % n] += np.fft.fft(oracles.make_fm_iq(mpx, 0.25)) * (
            n / sc)
    band = np.fft.ifft(spec)
    band += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return band.astype(np.complex64)


def _leaves(tree):
    out = []
    graphs._flatten(tree, out)
    return out


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


# ---- the counter registry -------------------------------------------------

def test_every_kernel_counter_is_registered():
    from radiocore_tpu_torch.kernels import (extract, extract_demod,
                                             fft_mixed, fft_rows, fir,
                                             nco_pll)
    for counter in (fft_rows.launches, *fft_rows.entry_launches.values(),
                    fft_mixed.launches, extract.launches,
                    extract.gather_launches, extract_demod.launches, extract_demod.spec_launches,
                    fir.launches, nco_pll.launches):
        assert any(c is counter for c in COUNTERS)
    fresh = LaunchCounter()
    assert COUNTERS[-1] is fresh


def test_capture_records_deltas_and_replays_add_them():
    a, b = LaunchCounter(), LaunchCounter()

    def fn(x):
        a.count += 2   # as a wrapper counts its launches
        b.count += 1
        return x + 1

    step, stub = _stub_step(fn)
    a.count = b.count = 5
    step(torch.zeros(3))
    # The warm-up and the capture leave the counters as they were; the
    # replay adds what the capture counted.
    assert (a.count, b.count) == (7, 6)
    entry = next(iter(step._graphs.values()))
    assert entry.launches == {a: 2, b: 1}
    for _ in range(3):
        step(torch.zeros(3))
    assert (a.count, b.count) == (13, 9)
    assert (stub.captures, stub.replays) == (1, 4)


def test_a_compiled_step_counts_what_its_eager_body_counts():
    from radiocore_tpu_torch.kernels import fft_rows
    calls = []

    def fn(x):
        calls.append(1)
        fft_rows.launches.count += 3
        return x * 2

    step, _ = _stub_step(fn)
    fft_rows.launches.reset()
    step(torch.ones(4))
    step(torch.ones(4))
    assert fft_rows.launches.count == 6
    fft_rows.launches.reset()
    step.eager(torch.ones(4))
    assert fft_rows.launches.count == 3
    # Three warm-up runs, one capture, two replays.
    assert len(calls) == graphs.WARMUP_RUNS + 3 + 1


# ---- copy-in, clone-out, signatures ---------------------------------------

def _chain(x, state):
    y = x * state["g"] + state["acc"][..., :1]
    return y, {"g": state["g"] + 1.0, "acc": torch.cumsum(x, -1)}


def test_inputs_are_copied_in_and_outputs_are_fresh():
    step, _ = _stub_step(_chain)
    x0 = torch.arange(6.0)
    s0 = {"g": torch.tensor(2.0), "acc": torch.zeros(6)}
    y1, s1 = step(x0, s0)
    assert _equal((y1, s1), _chain(x0, s0))
    held = (y1.clone(), {k: v.clone() for k, v in s1.items()})
    y2, s2 = step(x0 + 10, s1)
    # Chunk 1's outputs are not the graph's buffers: chunk 2 left them.
    assert _equal((y1, s1), held)
    assert _equal((y2, s2), _chain(x0 + 10, held[1]))
    # Two calls from one state give equal outputs.
    assert _equal(step(x0, s0), (y1, s1))
    # The caller's tensors are read, never written.
    assert torch.equal(x0, torch.arange(6.0))
    assert float(s0["g"]) == 2.0


@pytest.mark.parametrize("change", ["shape", "dtype", "static", "tree"])
def test_a_new_signature_makes_a_new_graph(change):
    def fn(x, k, extra=None):
        out = x * k
        return out if extra is None else out + extra["b"]

    step, stub = _stub_step(fn)
    x = torch.ones(4)
    step(x, 2)
    step(torch.zeros(4), 2)       # same signature: replayed
    assert step.graph_count == 1
    args = {"shape": (torch.ones(5), 2),
            "dtype": (torch.ones(4, dtype=torch.float64), 2),
            "static": (x, 3),
            "tree": (x, 2, {"b": torch.ones(4)})}[change]
    got = step(*args)
    assert step.graph_count == 2 and stub.captures == 2
    assert _equal(got, fn(*args))
    # Each signature replays its own graph.
    assert _equal(step(x, 2), fn(x, 2))
    assert step.graph_count == 2


def test_named_tuple_state_round_trips():
    class Pair(NamedTuple):
        phase: torch.Tensor
        freq: torch.Tensor

    def fn(x, st):
        return x + st.phase, {"pll": Pair(st.phase + 1, st.freq * 2)}

    step, _ = _stub_step(fn)
    st = Pair(torch.ones(3), torch.full((3,), 2.0))
    got = step(torch.zeros(3), st)
    assert isinstance(got[1]["pll"], Pair)
    assert _equal(got, fn(torch.zeros(3), st))


def test_a_leaf_on_another_device_raises():
    step = graphs.Step(lambda x: x, torch.device("meta"), StubGraphs())
    with pytest.raises(ValueError, match="meta"):
        step(torch.ones(2))


# ---- keep-list ------------------------------------------------------------

def test_constants_handed_out_during_a_capture_are_kept():
    from radiocore_tpu_torch.ops.consts import HostConst

    made = []

    @graphs.device_cache(maxsize=1)
    def table(n):
        made.append(torch.arange(float(n)))
        return made[-1]

    host = HostConst(np.ones(3, np.float32))
    assert graphs.hold(7) == 7        # no capture: nothing is kept

    def fn(x):
        return x * table(3).sum() + host.on(x.device).sum()

    step, _ = _stub_step(fn)
    step(torch.ones(2))
    keep = next(iter(step._graphs.values())).keep
    assert any(t is made[0] for t in keep)
    assert any(t is host.on(torch.device("cpu")) for t in keep)
    table(4)   # evicts the capture's table from the cache
    table.cache_clear()
    assert any(t is made[0] for t in keep)


# ---- the port's steps -----------------------------------------------------

@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_multi_station_step_compiled_matches_eager_and_jax(mode):
    from radiocore_tpu.parallel.pipeline import (
        make_multi_station_step as jax_step)
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    c, sc, ac = PLAN
    n, offs = c * sc, _offsets(c, sc)
    step, state = make_multi_station_step(n, offs, sc, ac, mode=mode,
                                          device="cpu")
    assert isinstance(step, graphs.Step)
    assert list(step.stages) == ["band_fft", "extract", "demod_tail"]
    step_j, state_j = jax_step(n, offs, sc, ac, mode=mode)
    stub, _ = _stub_step(step.eager)
    rng = np.random.default_rng(21)
    st_stub = state
    for _ in range(2):
        band = _fm_band(rng, c, sc)
        got = step(torch.from_numpy(band), state)
        assert _equal(got, step.eager(torch.from_numpy(band), state))
        stubbed = stub(torch.from_numpy(band), st_stub)
        assert _equal(stubbed, got)
        want, state_j = step_j(jnp.asarray(band), state_j)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                                   atol=ATOL)
        state, st_stub = got[1], stubbed[1]


def _wbfm_iq(seconds, fs=FS):
    mpx = oracles.make_stereo_multiplex(seconds * fs, fs, 700.0, 300.0)
    return oracles.make_fm_iq(mpx, 0.25).astype(np.complex64).reshape(
        seconds, fs)


@pytest.mark.parametrize("name", ["WBFM", "MFM", "FM"])
def test_model_classes_compiled_match_jax(name):
    import radiocore_tpu as rc
    from radiocore_tpu_torch import models
    ref = getattr(rc, name)(FS, AUDIO)
    port = getattr(models, name)(FS, AUDIO, device="cpu")
    assert isinstance(port._step, graphs.Step)
    for chunk in _wbfm_iq(2):
        want = ref.run(chunk)
        got = port.run(chunk)
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_wbfm_nco_step_through_a_stub_graph_equals_eager(monkeypatch):
    """The ``nco`` state (a ``PLLState`` inside the dict) through the
    graph path, at a small rate with one warm-up run: the plain loop runs
    in Python."""
    from radiocore_tpu_torch.models.wbfm import (make_wbfm_step,
                                                 wbfm_init_state)
    from radiocore_tpu_torch.ops.nco_pll import PLLState
    monkeypatch.setattr(graphs, "WARMUP_RUNS", 1)
    fs, audio = 40_000, 8_000
    eager = make_wbfm_step(fs, audio, pll="nco")
    step, _ = _stub_step(eager)
    state = wbfm_init_state(audio, batch_shape=(1,), pll="nco", device="cpu")
    iq = torch.from_numpy(_wbfm_iq(1, fs))
    got = step(iq, state)
    assert isinstance(got[1]["pll"], PLLState)
    assert _equal(got, eager(iq, state))


# ---- where graphs are made ------------------------------------------------

def test_compile_step_on_the_cpu_is_the_eager_function():
    step = graphs.compile_step(lambda x: x + 1, "cpu")
    assert step.device == torch.device("cpu")
    assert torch.equal(step(torch.zeros(2)), torch.ones(2))
    assert step.graph_count == 0
    with pytest.raises(ValueError, match="no graphs"):
        graphs.compile_step(lambda x: x, "meta")


@pytest.mark.parametrize("make", ["compile_step", "WBFM", "MFM", "FM",
                                  "Decimate", "Tuner"])
def test_asking_for_cuda_without_a_card_raises(make, monkeypatch):
    from radiocore_tpu_torch import models
    from radiocore_tpu_torch.tools.tuner import Tuner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {"compile_step": lambda: graphs.compile_step(lambda x: x,
                                                         "cuda"),
             "WBFM": lambda: models.WBFM(FS, AUDIO, device="cuda"),
             "MFM": lambda: models.MFM(FS, AUDIO, device="cuda"),
             "FM": lambda: models.FM(FS, AUDIO, device="cuda"),
             "Decimate": lambda: models.Decimate(FS, AUDIO, device="cuda"),
             "Tuner": lambda: Tuner(device="cuda")}[make]
    with pytest.raises(RuntimeError, match="is_available"):
        build()


"""The port's span recorder (``runtime/profiling``) and the spans of the
compiled step (``runtime/graphs``) and of the multi-station step, on the
CPU.

A CUDA graph and its timing events exist only on a card, so the graph
path runs through ``StubGraphs`` of ``tests/test_torch_graphs.py``, whose
timing events are its ``FakeEvent``: a record advances their clock one
unit and a stub replay ten."""

import time
import types

import pytest
import torch

from radiocore_tpu_torch.runtime import graphs, profiling
from radiocore_tpu_torch.runtime.profiling import (Call, Recorder, Span,
                                                   StageTimer, span, tracing)
from test_torch_graphs import PLAN, FakeEvent, StubGraphs, _offsets

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test."""
    rec = Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _forbidden(*args, **kwargs):
    raise AssertionError("called where it must not be")


def _body(x, state):
    return x * 2.0 + state["s"], {"s": state["s"] + x.sum()}


def _args():
    return torch.arange(8, dtype=torch.float32), {"s": torch.ones(())}


def _names(rec):
    return [s.name for s in rec.spans]


# ---- tracing off -----------------------------------------------------------

def test_off_span_is_one_shared_object(recorder):
    assert not profiling.on()
    a, b = span("a"), span("b", 3)
    assert a is b
    with a:
        with b:
            pass
    assert list(recorder.spans) == []


def test_off_span_makes_nothing(monkeypatch):
    """With tracing off a span builds no span object, opens no range and
    reads no clock: it hands out the one shared no-op context."""
    monkeypatch.setattr(profiling, "_Span", _forbidden)
    monkeypatch.setattr(profiling, "_Range", _forbidden)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", _forbidden)
    shared = span("first")
    for i in range(100):
        with span(f"s{i}", i) as inside:
            assert inside is None
        assert span("x") is shared


def test_off_step_records_nothing(recorder, monkeypatch):
    """With tracing off a compiled call opens no range, reads no clock,
    records no event and keeps nothing."""
    stub = StubGraphs()
    step = graphs.Step(_body, torch.device("cpu"), stub)
    monkeypatch.setattr(profiling, "_Range", _forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", _forbidden)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", _forbidden)
    monkeypatch.setattr(profiling, "CallEvents", _forbidden)
    monkeypatch.setattr(StubGraphs, "timing_event", _forbidden)
    for _ in range(3):
        step(*_args())
    assert stub.captures == 1 and stub.replays == 3
    assert step._traced_calls == 0 and step._call_events is None
    rep = profiling.report()
    assert rep == {"spans": [], "calls": [], "stages": []}


# ---- turning it on ---------------------------------------------------------

def test_tracing_context_turns_on_and_nests(recorder):
    with tracing() as rec:
        assert rec is recorder and profiling.on() and profiling.timed()
        with tracing():
            assert profiling.on()
        assert profiling.on()
        with span("a"):
            pass
    assert not profiling.on()
    assert _names(recorder) == ["a"]


def test_cpu_profile_turns_on_and_shows_ranges(recorder):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.on() and not profiling.timed()
        with span("outer"):
            with span("inner"):
                torch.ones(4).sum()
    assert not profiling.on()
    names = {e.name for e in prof.events()}
    assert {"radiocore.outer", "radiocore.inner"} <= names
    assert _names(recorder) == ["inner", "outer"]


def test_device_trace_holds_the_spans(recorder, tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with span("served"):
            torch.ones(4).sum()
    text = next(tmp_path.glob("*.json")).read_text()
    assert "radiocore.served" in text
    assert _names(recorder) == ["served"]


def test_the_profiler_hooks_are_torchs_own():
    """Tracing reads two private names of torch's profiler; a torch
    without them would trace only inside tracing() and draw device
    annotations, so an upgrade that drops them fails here."""
    assert profiling._profiler is torch.autograd.profiler
    assert profiling._Range is torch._C._profiler._RecordFunctionFast


def test_the_hooks_fall_back_without_the_private_names():
    flag, rng = profiling._hooks(types.SimpleNamespace(),
                                 types.SimpleNamespace())
    assert flag._is_profiler_enabled is False
    assert rng is torch.profiler.record_function


def test_profile_alone_traces_the_untraced_graph(recorder, monkeypatch):
    """Under a profile alone a compiled call records its host spans and
    replays the graph it replays untraced: no capture, no timing event."""
    from torch.profiler import ProfilerActivity, profile
    stub = StubGraphs()
    step = graphs.Step(_body, torch.device("cpu"), stub)
    want = step(*_args())
    monkeypatch.setattr(profiling, "CallEvents", _forbidden)
    monkeypatch.setattr(StubGraphs, "timing_event", _forbidden)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [step(*_args()) for _ in range(2)]
    assert stub.captures == 1 and step.graph_count == 1
    for out, state in got:
        assert torch.equal(out, want[0])
        assert torch.equal(state["s"], want[1]["s"])
    assert _names(recorder) == ["step.copy_in", "step.replay",
                                "step.clone_out", "step"] * 2
    assert [s.id for s in recorder.spans] == [1] * 4 + [2] * 4
    assert profiling.report()["calls"] == []
    names = {e.name for e in prof.events()}
    assert {"radiocore.step", "radiocore.step.replay"} <= names


def test_profile_alone_adds_nothing_to_a_capture(recorder, monkeypatch):
    """A capture under a profile alone builds the untraced graph: its
    spans are the shared no-op, with no event in the keep-list."""
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _forbidden)
    keep = []
    token = graphs._KEEP.set(keep)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with span("band_fft", 4) as inside:
                assert inside is None
    finally:
        graphs._KEEP.reset(token)
    assert keep == [] and profiling.report() == {"spans": [], "calls": [],
                                                 "stages": []}


# ---- the recorder ----------------------------------------------------------

def test_parents_ids_and_times(recorder):
    with tracing():
        with span("top"):
            with span("call", 7):
                with span("child"):
                    time.sleep(0.002)
                with span("sibling", 9):
                    pass
    by = {s.name: s for s in recorder.spans}
    assert by["top"].parent is None and by["top"].id is None
    assert by["call"] == by["call"]._replace(parent="top", id=7)
    assert by["child"].parent == "call" and by["child"].id == 7
    assert by["sibling"].parent == "call" and by["sibling"].id == 9
    assert by["child"].end_ns - by["child"].start_ns >= 2_000_000
    assert by["top"].start_ns <= by["call"].start_ns
    assert by["call"].end_ns <= by["top"].end_ns
    assert all(isinstance(s, Span) for s in recorder.spans)


def test_a_span_that_raises_is_kept_and_closed(recorder):
    with tracing():
        with pytest.raises(ValueError):
            with span("bad"):
                raise ValueError("x")
        with span("next"):
            pass
    assert [(s.name, s.parent) for s in recorder.spans] == [
        ("bad", None), ("next", None)]


def test_the_buffer_is_bounded(monkeypatch):
    assert profiling.CAPACITY >= 4096
    rec = Recorder(capacity=5)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    with tracing():
        for i in range(12):
            with span(f"s{i}"):
                pass
    assert _names(rec) == [f"s{i}" for i in range(7, 12)]


def test_spans_of_threads_keep_their_own_parents(recorder):
    import threading

    def work(name):
        with span(name):
            for _ in range(50):
                with span(name + ".child"):
                    pass

    with tracing():
        threads = [threading.Thread(target=work, args=(f"t{i}",))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for s in recorder.spans:
        if s.name.endswith(".child"):
            assert s.parent == s.name[:-len(".child")]


# ---- device events ---------------------------------------------------------

def test_call_events_resolve_and_a_reused_slot_is_lost():
    ring = profiling.CallEvents(FakeEvent, depth=4)
    for n in range(1, 7):
        for i in range(4):
            ring.mark(n, i)
            if i == 1:
                FakeEvent.now += 10.0       # the replay
        FakeEvent.now += 100.0              # the host between calls
    assert ring.resolve(1) is None and ring.resolve(2) is None
    assert ring.resolve(3) == Call(3, 1.0, 11.0, 1.0, None)
    assert ring.resolve(4) == Call(4, 1.0, 11.0, 1.0, 101.0)
    assert ring.resolve(6) == Call(6, 1.0, 11.0, 1.0, 101.0)


def test_in_graph_span_records_events_into_the_keep_list(recorder,
                                                         monkeypatch):
    """Inside a capture a span is a pair of timing events that the graph
    keeps; they give the latest replay's time when the recorder
    reports, and nothing before a replay."""
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda **kwargs: FakeEvent())
    keep = []
    token = graphs._KEEP.set(keep)
    try:
        with tracing():
            with span("band_fft", 4):
                pass
    finally:
        graphs._KEEP.reset(token)
    assert list(recorder.spans) == []
    (start, end), = keep
    assert recorder.report()["stages"] == [("band_fft", 4, 1.0)]
    start.t = None
    assert recorder.report()["stages"] == [("band_fft", 4, None)]


# ---- the compiled step -----------------------------------------------------

def test_traced_step_through_a_stub_graph(recorder):
    stub = StubGraphs()
    step = graphs.Step(_body, torch.device("cpu"), stub)
    want = [step(*_args()) for _ in range(2)]
    assert step.graph_count == 1
    with tracing():
        got = [step(*_args()) for _ in range(3)]
    assert step.graph_count == 2
    for (a, sa), (b, sb) in zip(want, got + got):
        assert torch.equal(a, b) and torch.equal(sa["s"], sb["s"])
    names = _names(recorder)
    assert names.count("step.capture") == 1
    assert names.count("step") == 3
    for n in (1, 2, 3):
        mine = [s for s in recorder.spans if s.id == n]
        top = next(s for s in mine if s.name == "step")
        kids = [s for s in mine if s.parent == "step"]
        assert top.parent is None
        want_kids = ["step.copy_in", "step.replay", "step.clone_out"]
        if n == 1:
            want_kids = ["step.capture"] + want_kids
        assert [s.name for s in kids] == want_kids
        for s in kids:
            assert top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns
    # the warm-up and capture ran the body under the capture span
    assert all(s.parent == "step.capture" for s in recorder.spans
               if s.name not in ("step", "step.capture", "step.copy_in",
                                 "step.replay", "step.clone_out"))
    calls = profiling.report()["calls"]
    assert [c.id for c in calls] == [1, 2, 3]
    assert all((c.copy_in_ms, c.replay_ms, c.clone_out_ms) == (1.0, 11.0,
                                                               1.0)
               for c in calls)
    assert [c.gap_ms for c in calls] == [None, 1.0, 1.0]
    # tracing off again: the untraced graph, nothing more recorded
    kept = len(recorder.spans)
    step(*_args())
    assert len(recorder.spans) == kept and step.graph_count == 2


def test_eager_step_records_the_call_span(recorder):
    step = graphs.compile_step(_body, "cpu")
    with tracing():
        step(*_args())
        step(*_args())
    assert [(s.name, s.id) for s in recorder.spans] == [("step", 1),
                                                        ("step", 2)]


# ---- the multi-station step --------------------------------------------------

@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_multi_station_stage_spans(recorder, mode):
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    c, sc, ac = PLAN
    step, state = make_multi_station_step(c * sc, _offsets(c, sc), sc, ac,
                                          mode=mode, device="cpu")
    band = torch.zeros(c * sc, dtype=torch.complex64)
    band[::7] = 1.0
    want, _ = step(band, state)
    with tracing():
        got, _ = step(band, state)
    assert torch.equal(want, got)
    spans = list(recorder.spans)
    assert [s.name for s in spans] == list(step.stages) + ["step"]
    assert all(s.parent == "step" and s.id == 1 for s in spans[:-1])


# ---- StageTimer --------------------------------------------------------------

def test_stage_timer_stages_are_spans(recorder):
    t = StageTimer()
    with tracing():
        with t.stage("source"):
            time.sleep(0.002)
        with t.stage("fetch", sync_value=torch.ones(2)):
            pass
    with t.stage("source"):
        pass
    rep = t.report()
    assert rep["source"]["count"] == 2 and rep["fetch"]["count"] == 1
    assert rep["source"]["total_s"] >= 0.002
    assert _names(recorder) == ["source", "fetch"]
    first = recorder.spans[0]
    assert first.end_ns - first.start_ns >= 2_000_000

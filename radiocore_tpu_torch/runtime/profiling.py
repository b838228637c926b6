"""Tracing and profiling helpers; counterpart of
``radiocore_tpu/runtime/profiling.py``: the program's span recorder, a
``torch.profiler`` trace of a block of code, and named-stage wall timers
that wait on the device only where asked.

**Spans.** ``with span("name"):`` marks a stretch of the program. Tracing
is on inside :func:`tracing` and while any ``torch.profiler`` profile
records; otherwise :func:`span` returns one shared no-op context, at the
cost of reading whether tracing is on. With tracing on, a span on the host
opens a ``radiocore.<name>`` range in the profiler (a CPU range, on the
same clock as the kernels of a device trace) and appends a :class:`Span`
to the process's :class:`Recorder`: its name, the id it shares with the
spans around it (a compiled step's call number), its parent's name, and
its start and end on ``time.perf_counter_ns``.

Device events are recorded only inside :func:`tracing`: there a span
inside a CUDA graph capture is a pair of timing events in the graph,
which after each replay hold that replay's time of the span
(:class:`Stage`), and compiled steps (``runtime/graphs``) time each call
on the device (:class:`CallEvents`, :class:`Call`). A profile alone gets
the host spans and nothing on the device, so the work it traces is the
work that runs untraced. :func:`report` returns what was recorded and
resolves the device events; nothing else waits on the device for them.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import types
from typing import (Any, Callable, Deque, Dict, Iterator, List, NamedTuple,
                    Optional)

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "radiocore."      # of every span's range in a profiler trace
CAPACITY = 8192            # spans, calls and stages the recorder keeps
CALL_RING = 256            # traced calls of one compiled step timed at once

# ---- spans -----------------------------------------------------------------

class Span(NamedTuple):
    """One span on the host: ``id`` is shared by the spans of one
    compiled-step call (its call number on that step; None outside one),
    ``parent`` is the enclosing span's name."""
    name: str
    id: Optional[int]
    parent: Optional[str]
    start_ns: int
    end_ns: int


class Call(NamedTuple):
    """One traced call of a compiled step on the device, in ms: copy-in,
    replay and clone-out, and the device's idle from the previous traced
    call's clone-out end to this call's copy-in start (None where that
    call is not in the ring any more)."""
    id: int
    copy_in_ms: float
    replay_ms: float
    clone_out_ms: float
    gap_ms: Optional[float]


class Stage(NamedTuple):
    """A span captured into a CUDA graph: its time in the graph's latest
    replay (None before the first), ``id`` that of the call that built
    the graph."""
    name: str
    id: Optional[int]
    ms: Optional[float]


class CallEvents:
    """Timing events for the traced calls of one compiled step: four a
    call (copy-in start, replay start, replay end, clone-out end) from a
    ring :data:`CALL_RING` calls deep, made once by ``make_event`` and
    recorded once here so that no call creates one. A slot remembers the
    call it holds, so a call whose slot was taken again resolves to
    nothing."""

    def __init__(self, make_event: Callable[[], Any],
                 depth: int = CALL_RING):
        self.events = [[make_event() for _ in range(4)]
                       for _ in range(depth)]
        for quad in self.events:
            for ev in quad:
                ev.record()
        self.calls: List[Optional[int]] = [None] * depth

    def mark(self, n: int, i: int) -> None:
        """Record call ``n``'s event ``i`` (0 to 3) on the current
        stream; the last hands the call to the recorder."""
        slot = n % len(self.calls)
        if i == 0:
            self.calls[slot] = n
        self.events[slot][i].record()
        if i == 3:
            RECORDER.call(self, n)

    def resolve(self, n: int) -> Optional[Call]:
        """Call ``n``'s device times, once its events have run."""
        depth = len(self.calls)
        slot, prev = n % depth, (n - 1) % depth
        if self.calls[slot] != n:
            return None
        a, b, c, d = self.events[slot]
        d.synchronize()
        gap = (self.events[prev][3].elapsed_time(a)
               if self.calls[prev] == n - 1 else None)
        return Call(n, a.elapsed_time(b), b.elapsed_time(c),
                    c.elapsed_time(d), gap)


class Recorder:
    """What tracing recorded in this process, each kind bounded to its
    newest ``capacity`` entries: host spans, compiled-step calls (resolved
    into :class:`Call` by :meth:`report`) and spans captured into
    graphs."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: Deque[Span] = collections.deque(maxlen=capacity)
        self.calls: Deque[Any] = collections.deque(maxlen=capacity)
        self.stages: Deque[tuple] = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._calls_lock = threading.Lock()

    def stack(self) -> List["_Span"]:
        """This thread's open spans, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def call(self, events: CallEvents, n: int) -> None:
        """Keep call ``n`` of a compiled step, timed by ``events``."""
        with self._calls_lock:
            self.calls.append((events, n))

    def report(self) -> Dict[str, list]:
        """``spans``, ``calls`` and ``stages`` as lists, oldest first.
        Waits for the device events it resolves."""
        with self._calls_lock:
            calls = []
            for entry in self.calls:
                if not isinstance(entry, Call):
                    entry = entry[0].resolve(entry[1])
                if entry is not None:
                    calls.append(entry)
            self.calls = collections.deque(calls, maxlen=self.calls.maxlen)
        return {"spans": list(self.spans), "calls": calls,
                "stages": [Stage(name, id_, _elapsed_ms(a, b))
                           for name, id_, a, b in self.stages]}


def _elapsed_ms(start, end) -> Optional[float]:
    """ms between two events captured into a graph, after its latest
    replay; None before its first."""
    try:
        end.synchronize()
        return start.elapsed_time(end)
    except RuntimeError:
        return None


RECORDER = Recorder()
_forced = 0
_forced_lock = threading.Lock()


def _hooks(autograd_profiler: Any, c_profiler: Any):
    """What tracing needs of torch's profiler, looked up once: the object
    whose ``_is_profiler_enabled`` says whether a ``torch.profiler``
    profile records, and the range a host span opens. Both are private to
    torch; without the flag tracing is on only inside :func:`tracing`,
    and without the CPU-only range a span opens ``record_function`` (which
    also draws an annotation on the device's timeline)."""
    flag = (autograd_profiler
            if hasattr(autograd_profiler, "_is_profiler_enabled")
            else types.SimpleNamespace(_is_profiler_enabled=False))
    rng = (getattr(c_profiler, "_RecordFunctionFast", None)
           or torch.profiler.record_function)
    return flag, rng


_profiler, _Range = _hooks(_autograd_profiler, torch._C._profiler)


def on() -> bool:
    """Whether tracing is on: inside :func:`tracing`, or while a
    ``torch.profiler`` profile records."""
    return bool(_forced or _profiler._is_profiler_enabled)


def timed() -> bool:
    """Whether tracing records device events: only inside
    :func:`tracing`. A profile alone gets host spans, so that what it
    traces is the program as it runs untraced."""
    return bool(_forced)


@contextlib.contextmanager
def tracing() -> Iterator[Recorder]:
    """Tracing on inside the block (nested blocks too), device events
    included; yields the recorder."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield RECORDER
    finally:
        with _forced_lock:
            _forced -= 1


def report() -> Dict[str, list]:
    """What the process's recorder holds (:meth:`Recorder.report`)."""
    return RECORDER.report()


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


class _Open:
    """An open span on its thread's stack: the enclosing span is its
    parent, and it takes that span's id unless given one."""

    __slots__ = ("rec", "name", "id", "parent")

    def __init__(self, rec: Recorder, name: str, call_id: Optional[int]):
        self.rec, self.name, self.id = rec, name, call_id

    def _push(self) -> None:
        stack = self.rec.stack()
        top = stack[-1] if stack else None
        self.parent = top.name if top is not None else None
        if self.id is None and top is not None:
            self.id = top.id
        stack.append(self)


class _Span(_Open):
    """A span on the host (module docstring)."""

    __slots__ = ("range", "t0")

    def __enter__(self) -> "_Span":
        self._push()
        self.range = _Range(PREFIX + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self.range.__exit__(*exc)
        self.rec.spans.append(Span(self.name, self.id, self.parent,
                                   self.t0, t1))
        self.rec.stack().pop()
        return False


class _InGraph(_Open):
    """A span inside a CUDA graph capture: two timing events that the
    graph keeps (``graphs.hold``), recorded as nodes of the graph."""

    __slots__ = ("events",)

    def __enter__(self) -> "_InGraph":
        from radiocore_tpu_torch.runtime.graphs import hold
        self._push()
        self.events = hold(
            (torch.cuda.Event(enable_timing=True, external=True),
             torch.cuda.Event(enable_timing=True, external=True)))
        self.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        self.events[1].record()
        self.rec.stages.append((self.name, self.id) + self.events)
        self.rec.stack().pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str, call_id: Optional[int] = None):
    """A span named ``name`` (module docstring); ``call_id`` None takes
    the enclosing span's id. Inside a capture, a pair of timing events
    inside :func:`tracing` and nothing under a profile alone: a capture
    is not a call, and its graph is the untraced one."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    if _capturing():
        return _InGraph(RECORDER, name, call_id) if _forced else _OFF
    return _Span(RECORDER, name, call_id)


# ---- device traces and stage timers ----------------------------------------

# torch.profiler can drop the first events of its window on the card: a
# window opens with this many milliseconds of small launches.
_LEAD_MS = 100.0


def _cuda_devices(value: Any) -> List[torch.device]:
    """The CUDA devices the tensors in ``value`` (a tensor, or a tuple,
    list or dict of them, nested) live on."""
    if isinstance(value, torch.Tensor):
        return [value.device] if value.is_cuda else []
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        found: List[torch.device] = []
        for item in value:
            found += [d for d in _cuda_devices(item) if d not in found]
        return found
    return []


def sync(value: Any) -> Any:
    """Wait until the device work behind ``value`` is done and return it:
    ``torch.cuda.synchronize`` on each CUDA device its tensors live on;
    nothing for CPU tensors, whose work is done when the call returns."""
    for device in _cuda_devices(value):
        torch.cuda.synchronize(device)
    return value


def _lead_in() -> None:
    """:data:`_LEAD_MS` of small launches on the card, waited on one by
    one."""
    x = torch.zeros(1024, device="cuda")
    t0 = time.perf_counter()
    while (time.perf_counter() - t0) * 1e3 < _LEAD_MS:
        x.add_(1.0)
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[Any]:
    """Trace everything inside the block with ``torch.profiler`` (CPU
    activity, and CUDA activity where there is a card) and write it as a
    Chrome trace into ``log_dir``; yields the profiler. The program's
    spans are on while it records, so the trace shows them as
    ``radiocore.<name>`` ranges beside the kernels, and :func:`report`
    holds them afterwards; the device runs what it runs untraced. Inside
    :func:`tracing` the trace also holds its timing events.

    Where there is a card the window opens with a lead-in of small
    launches before the block runs (see :data:`_LEAD_MS`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            _lead_in()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulating named-stage wall timers with device sync.

    ``with timer.stage("channelize"): ...`` times the block on the host's
    clock. Kernel launches return before the device has run them, so a
    stage measures its device work only where it waits for it: pass the
    stage's result as ``sync_value``, or call :meth:`sync` on it. Each
    stage is also a :func:`span` of its name.
    """

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None) -> Iterator[None]:
        """Time one named stage; wait on ``sync_value`` (a tensor, or a
        tuple, list or dict of them) before the clock stops, so that its
        device work is charged to this stage."""
        t0 = time.perf_counter()
        with span(name):
            try:
                yield
            finally:
                if sync_value is not None:
                    sync(sync_value)
                dt = time.perf_counter() - t0
                self._totals[name] = self._totals.get(name, 0.0) + dt
                self._counts[name] = self._counts.get(name, 0) + 1

    def sync(self, value):
        """Wait on the device work behind ``value`` and return it."""
        return sync(value)

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per-stage ``{name: {total_s, count, mean_ms}}`` summary."""
        return {
            name: {"total_s": total,
                   "count": self._counts[name],
                   "mean_ms": 1e3 * total / self._counts[name]}
            for name, total in self._totals.items()
        }

    def __repr__(self) -> str:
        lines = [f"  {k}: {v['mean_ms']:.2f} ms × {v['count']}"
                 for k, v in sorted(self.report().items())]
        return "StageTimer(\n" + "\n".join(lines) + "\n)"

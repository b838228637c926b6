"""Compiled steps: the port's counterpart of the JAX package's ``jax.jit``.

The JAX package jits every step it serves: built once per shape, a chunk
is then one host call that dispatches the whole program. On a CUDA
device :func:`compile_step` gives the same contract with a CUDA graph.
The first call with a new signature (the tensors' shapes, dtypes, strides
and device, the other arguments' values, the structure of dicts, lists
and tuples around them):

1. runs the eager function :data:`WARMUP_RUNS` times on a side stream
   (PyTorch's documented warm-up: it builds the kernels, the cuFFT plans,
   the C-side twiddle tables and K-EXTRACT's side streams, none of which
   may be made inside a capture);
2. captures one run on static input buffers into a
   ``torch.cuda.CUDAGraph``;
3. keeps the graph under the signature, as jit retraces on a new shape.

Each call copies the caller's tensors into the static inputs, replays the
graph and returns fresh tensors, cloned out of the graph's pool: a caller
may hold chunk N's audio across chunk N+1, or call twice from one state,
as with the JAX package's functional steps. A failed capture or replay
raises; nothing runs the eager body in its place. On the CPU a compiled
step is its eager function. The eager body stays reachable as
``step.eager``, and a step's ``stages`` as they were.

The capture uses ``capture_error_mode="thread_local"``: a serving loop
may share its process with other threads that make CUDA calls (a
producer, an ingest pipe), and only the capturing thread's calls belong
to the graph.

Two things a replay would otherwise lose:

* **launch counts.** The kernels' wrappers count their launches in
  Python (``kernels.fft_rows.LaunchCounter``), which a replay goes
  around. A capture records what it added to every registered counter,
  and each replay adds that again, so a compiled step counts per call
  what its eager body launches. The warm-up and the capture are the
  step's build, as jit's trace and compile are, and leave the counters
  as they found them.
* **the life of cached constants.** The kernels take raw pointers, so
  PyTorch cannot see that a graph reads a cached device constant (a
  window, taps, twiddles). Every such cache hands its tensors out through
  :func:`hold` (:func:`device_cache` does it for an ``lru_cache``), which
  during a capture appends them to the graph's keep-list: an evicted
  entry then stays alive for as long as the graph that reads it.

With tracing on (``runtime/profiling``) a call is traced: it records the
span ``step``, whose id is the call's number among this step's traced
calls, with ``step.copy_in``, ``step.replay`` and ``step.clone_out``
inside it, and ``step.capture`` around the warm-up and capture of a call
that builds a graph. Under a ``torch.profiler`` profile alone that is
all, and the graph replayed is the untraced one. Inside
``profiling.tracing()`` a call also records four timing events on the
current stream (``profiling.CallEvents``, resolved only when the recorder
reports), and the signature includes it, so the first such call captures
a traced variant of the graph, in which the body's spans are timing
events: a one-time warm-up and capture, and a second graph's memory,
while the untraced graph stays as it was. With tracing off a call reads
the flag and does nothing else of this.
"""

from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Any, Callable, Dict, Hashable, Iterator, List, Optional

import torch

from radiocore_tpu_torch.kernels.fft_rows import COUNTERS, LaunchCounter
from radiocore_tpu_torch.runtime import profiling

WARMUP_RUNS = 3

_KEEP: contextvars.ContextVar[Optional[List[Any]]] = contextvars.ContextVar(
    "radiocore_tpu_torch_graph_keep", default=None)


def hold(obj):
    """Return ``obj``; while a step is being captured, that step's graph
    also keeps a reference to it for as long as the graph lives."""
    keep = _KEEP.get()
    if keep is not None:
        keep.append(obj)
    return obj


def device_cache(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function whose results a
    captured graph may read by pointer (device constants, or closures
    that hold them): every result goes out through :func:`hold`."""
    def decorate(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            return hold(cached(*args))

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get
    return decorate


def launch_counts() -> Dict[LaunchCounter, int]:
    """Every registered launch counter's count."""
    return {c: c.count for c in COUNTERS}


def _set_counts(counts: Dict[LaunchCounter, int]) -> None:
    for c in COUNTERS:
        c.count = counts.get(c, 0)


# ---- argument trees: dicts, lists and tuples (NamedTuples too) -----------

def _flatten(tree, leaves: List[Any]) -> Hashable:
    """Append ``tree``'s leaves to ``leaves``; return its structure."""
    if isinstance(tree, dict):
        keys = tuple(tree)
        return (dict, keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    leaves.append(tree)
    return None


def _unflatten(struct: Hashable, leaves: Iterator[Any]):
    if struct is None:
        return next(leaves)
    kind = struct[0]
    if kind is dict:
        return {k: _unflatten(s, leaves)
                for k, s in zip(struct[1], struct[2])}
    items = [_unflatten(s, leaves) for s in struct[1]]
    if kind is list:
        return items
    if kind is tuple:
        return tuple(items)
    return kind(*items)


def _leaf_key(leaf) -> Hashable:
    if isinstance(leaf, torch.Tensor):
        return (torch.Tensor, tuple(leaf.shape), leaf.dtype, leaf.stride(),
                leaf.device)
    return leaf


# ---- capture ---------------------------------------------------------------

class CudaGraphs:
    """Warm-up, capture and replay on one CUDA device. The graphs of one
    step share a memory pool: they replay one at a time, and each keeps
    its outputs, so none reads memory that another has reused."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = None

    def warm_up(self, run: Callable[[], Any], times: int) -> None:
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            for _ in range(times):
                run()
        caller.wait_stream(side)

    def capture(self, run: Callable[[], Any]):
        """``(graph, outputs)`` of one captured run."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = run()
        return graph, out

    @staticmethod
    def replay(graph) -> None:
        graph.replay()

    @staticmethod
    def timing_event():
        return torch.cuda.Event(enable_timing=True)


@dataclasses.dataclass
class _Graph:
    graph: Any
    inputs: List[Optional[torch.Tensor]]   # static buffer per leaf, or None
    out_struct: Hashable
    out_leaves: List[Any]
    launches: Dict[LaunchCounter, int]     # added to the counters a call
    keep: List[Any]                        # what the graph reads by pointer


class Step:
    """A compiled step (module docstring). ``graphs`` is the capture
    backend (:class:`CudaGraphs` on a card); None runs ``fn`` eagerly."""

    def __init__(self, fn: Callable, device: torch.device,
                 graphs: Optional[Any] = None):
        self.eager = fn
        self.device = device
        if hasattr(fn, "stages"):
            self.stages = fn.stages
        self._backend = graphs
        self._graphs: Dict[Hashable, _Graph] = {}
        # Static input buffers by leaf position and signature, shared by
        # the graphs of every signature that has such a leaf there.
        self._buffers: Dict[Hashable, torch.Tensor] = {}
        self._traced_calls = 0
        self._call_events: Optional[profiling.CallEvents] = None

    @property
    def graph_count(self) -> int:
        """The signatures captured so far."""
        return len(self._graphs)

    def __call__(self, *args):
        if profiling.on():
            return self._traced_call(args)
        if self._backend is None:
            return self.eager(*args)
        entry, leaves = self._entry(args, False)
        _copy_in(entry, leaves)
        self._replay(entry)
        return _clone_out(entry)

    def _traced_call(self, args):
        """A call with tracing on (module docstring)."""
        self._traced_calls += 1
        n = self._traced_calls
        with profiling.span("step", n):
            if self._backend is None:
                return self.eager(*args)
            timed = profiling.timed()
            entry, leaves = self._entry(args, timed)
            ring = self._ring() if timed else None
            if ring is not None:
                ring.mark(n, 0)
            with profiling.span("step.copy_in"):
                _copy_in(entry, leaves)
            if ring is not None:
                ring.mark(n, 1)
            with profiling.span("step.replay"):
                self._replay(entry)
            if ring is not None:
                ring.mark(n, 2)
            with profiling.span("step.clone_out"):
                out = _clone_out(entry)
            if ring is not None:
                ring.mark(n, 3)
            return out

    def _ring(self) -> profiling.CallEvents:
        """This step's ring of call events, made on its first timed
        call."""
        if self._call_events is None:
            self._call_events = profiling.CallEvents(
                self._backend.timing_event)
        return self._call_events

    def _entry(self, args, timed: bool):
        """The graph for ``args``' signature, captured on first sight, and
        the arguments' leaves."""
        leaves: List[Any] = []
        struct = _flatten(args, leaves)
        key = (timed, struct, tuple(_leaf_key(x) for x in leaves))
        entry = self._graphs.get(key)
        if entry is None:
            with profiling.span("step.capture"):
                entry = self._graphs[key] = self._capture(struct, leaves)
        return entry, leaves

    def _replay(self, entry: _Graph) -> None:
        self._backend.replay(entry.graph)
        for counter, made in entry.launches.items():
            counter.count += made

    def _buffer(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        if leaf.device != self.device:
            raise ValueError(f"compiled step on {self.device}: argument "
                             f"leaf {i} is on {leaf.device}")
        key = (i,) + _leaf_key(leaf)
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = torch.empty(
                leaf.shape, dtype=leaf.dtype, device=leaf.device)
        return buf

    def _capture(self, struct: Hashable, leaves: List[Any]) -> _Graph:
        """Warm up on the caller's arguments, then capture on the static
        buffers (a capture runs nothing: the call fills them before the
        first replay)."""
        inputs = [self._buffer(i, x) if isinstance(x, torch.Tensor) else None
                  for i, x in enumerate(leaves)]
        args = _unflatten(struct, iter(leaves))
        static = _unflatten(struct, iter(
            leaf if buf is None else buf for buf, leaf in zip(inputs,
                                                              leaves)))
        before = launch_counts()
        self._backend.warm_up(lambda: self.eager(*args), WARMUP_RUNS)
        warm = launch_counts()
        keep: List[Any] = []
        token = _KEEP.set(keep)
        try:
            graph, out = self._backend.capture(lambda: self.eager(*static))
        finally:
            _KEEP.reset(token)
        captured = launch_counts()
        _set_counts(before)
        out_leaves: List[Any] = []
        out_struct = _flatten(out, out_leaves)
        return _Graph(graph, inputs, out_struct, out_leaves,
                      {c: n - warm.get(c, 0) for c, n in captured.items()
                       if n != warm.get(c, 0)}, keep)


def _copy_in(entry: _Graph, leaves: List[Any]) -> None:
    for buf, leaf in zip(entry.inputs, leaves):
        if buf is not None:
            buf.copy_(leaf)


def _clone_out(entry: _Graph):
    return _unflatten(entry.out_struct, iter(
        x.clone() if isinstance(x, torch.Tensor) else x
        for x in entry.out_leaves))


def compile_step(fn: Callable, device: torch.device | str) -> Step:
    """``fn`` as a compiled step on ``device`` (module docstring): CUDA
    graphs on a CUDA device, ``fn`` itself on the CPU. A CUDA device
    without a card raises."""
    device = torch.device(device)
    if device.type == "cpu":
        return Step(fn, device)
    if device.type != "cuda":
        raise ValueError(f"compile_step: no graphs for device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"compile_step: {device} asked for, but "
                           f"torch.cuda.is_available() is False")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Step(fn, device, CudaGraphs(device))

"""Overlapped host→device IQ ingest on the card's copy engine;
counterpart of ``radiocore_tpu/runtime/ingest.py``.

The JAX package overlaps transfers by async dispatch and donation
(``jax.device_put`` of a view, an unpack jit that reuses the staging
buffer). On a CUDA card the overlap is explicit:

* **page-locked slots**: ``depth + 1`` host buffers allocated once per
  chunk size with ``torch.empty(..., pin_memory=True)``. A copy from
  pageable memory would be synchronous, and pinning per chunk would be a
  ``cudaHostAlloc`` per chunk. Each host chunk is first copied into a
  free slot: that host memcpy frees the caller's buffer at once, so a
  producer may reuse its buffer as soon as :meth:`IngestPipe.stream`
  has taken the chunk;
* **a side stream**: the slot's host→device copy runs with
  ``non_blocking=True`` on a ``torch.cuda.Stream`` of its own, and an
  event is recorded after it. A slot is refilled only after that event
  has completed;
* **hand-over**: before a chunk is yielded, the consumer's current stream
  waits on the copy's event (:func:`verify_staged`), and the output is
  ``record_stream``-ed to the consumer's stream: it was allocated on the
  copy stream, and without that the caching allocator could hand its
  memory out again while the consumer still reads it.

With ``depth=2`` chunk N+1's copy is issued before chunk N is yielded, so
it runs while the consumer computes on chunk N; ``depth=1`` is the
synchronous shape (for A/B measurement). On a CPU device a chunk is a
plain copy. ``donate`` is kept in the signatures for parity and unused.

The reference's relay re-staging (``verify_staged``'s retry through the
blocking resilient path) is relay-only and is not ported: here
:func:`verify_staged` orders the consumer after the copy and returns,
and a failed copy raises.
"""

from __future__ import annotations

import collections
import dataclasses
import queue as _queue
import time
from typing import Deque, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.runtime.platform import resolve_device

Staged = Tuple[torch.Tensor, Optional[torch.cuda.Event]]


@dataclasses.dataclass
class CopyRecord:
    """One chunk's way onto the card: the host memcpy into its pinned slot
    (seconds on the host's clock) and the events around its host→device
    copy on the copy stream."""

    nbytes: int
    host_s: float
    start: torch.cuda.Event
    end: torch.cuda.Event

    def h2d_ms(self) -> float:
        """The host→device copy's time (both events must be complete)."""
        return self.start.elapsed_time(self.end)


class PinnedStager:
    """Page-locked host slots and a copy stream for one CUDA device.

    ``slots`` buffers of complex64 are allocated once per chunk size and
    reused round robin; :attr:`records` keeps the last 64 chunks'
    :class:`CopyRecord`.
    """

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._count = int(slots)
        self._n = -1
        self._bufs: List[torch.Tensor] = []
        self._views: List[np.ndarray] = []
        self._done: List[Optional[torch.cuda.Event]] = []
        self._next = 0
        self.records: Deque[CopyRecord] = collections.deque(maxlen=64)

    def _slots_for(self, n: int) -> None:
        if n == self._n:
            return
        # Blocks still read by a copy in flight stay alive: the caching
        # host allocator holds them until their copy's event completes.
        self._bufs = [torch.empty(n, dtype=torch.complex64, pin_memory=True)
                      for _ in range(self._count)]
        self._views = [b.numpy() for b in self._bufs]
        self._done = [None] * self._count
        self._next, self._n = 0, n

    def stage(self, arr: np.ndarray) -> Staged:
        """Copy ``arr`` into the next free slot, then start its copy to the
        card on the copy stream; returns the output and the copy's event."""
        arr = np.asarray(arr)
        self._slots_for(arr.size)
        i = self._next
        self._next = (i + 1) % self._count
        if self._done[i] is not None:
            self._done[i].synchronize()
        flat = arr.reshape(-1)
        t0 = time.perf_counter()
        if (flat.flags.writeable and flat.flags.c_contiguous
                and flat.dtype.isnative):
            # torch's copy runs on the intra-op threads; NumPy's on one.
            self._bufs[i].copy_(torch.from_numpy(flat))
        else:
            np.copyto(self._views[i], flat, casting="unsafe")
        host_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            out = torch.empty(arr.shape, dtype=torch.complex64,
                              device=self.device)
            start.record(self.stream)
            out.view(-1).copy_(self._bufs[i], non_blocking=True)
            end.record(self.stream)
        self._done[i] = end
        self.records.append(CopyRecord(self._bufs[i].nbytes, host_s, start,
                                       end))
        return out, end


def _host_copy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A CPU chunk: an owning complex64 copy (the caller may reuse
    ``arr`` at once)."""
    return torch.from_numpy(np.array(arr, dtype=np.complex64, copy=True)).to(
        device)


def stage_chunk(arr: np.ndarray, donate: bool = True, *,
                device: Optional[torch.device | str] = None) -> Staged:
    """Start the copy of one host chunk to ``device`` (the card when None)
    as complex64; returns ``(tensor, event)`` for :func:`verify_staged`
    (``event`` is None on the CPU). One call allocates one page-locked
    slot: for a stream of chunks use :class:`IngestPipe`, which allocates
    its slots once."""
    del donate
    device = resolve_device(device)
    if device.type != "cuda":
        return _host_copy(arr, device), None
    return PinnedStager(device, 1).stage(arr)


def verify_staged(chunk: torch.Tensor,
                  done: Optional[torch.cuda.Event] = None) -> torch.Tensor:
    """Order the current stream after the copy that made ``chunk`` (its
    event ``done``) and mark ``chunk`` as used there, then return it.
    The host does not wait: the consumer's kernels queue behind the copy.
    A copy that failed raises (here or at the next synchronisation)."""
    if done is not None:
        consumer = torch.cuda.current_stream(chunk.device)
        consumer.wait_event(done)
        chunk.record_stream(consumer)
    return chunk


class IngestPipe:
    """Double-buffered device ingest over an iterator of host chunks.

    ``depth`` chunks are kept in flight: chunk N+1's copy is issued before
    chunk N is yielded, so the copy engine runs while the consumer
    computes. ``depth=1`` reproduces the synchronous behavior (for A/B
    measurement). ``device`` is the card when None.
    """

    def __init__(self, depth: int = 2, donate: bool = True, *,
                 device: Optional[torch.device | str] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.depth = depth
        self.donate = donate
        self.device = resolve_device(device)
        self.stager = (PinnedStager(self.device, depth + 1)
                       if self.device.type == "cuda" else None)

    def _stage(self, arr: np.ndarray) -> Staged:
        if self.stager is None:
            return _host_copy(arr, self.device), None
        return self.stager.stage(arr)

    def stream(self, host_chunks: Iterable[np.ndarray]
               ) -> Iterator[torch.Tensor]:
        pending: List[Staged] = []
        for arr in host_chunks:
            pending.append(self._stage(arr))
            if len(pending) >= self.depth:
                yield verify_staged(*pending.pop(0))
        while pending:
            yield verify_staged(*pending.pop(0))


class ThreadedIngest:
    """IngestPipe fed from a producer thread (the ``receive_fm`` shape).

    The producer calls :meth:`put` with host chunks (e.g. straight out of
    a RingBuffer); the consumer iterates. Staging happens on the
    *consumer* side, so every CUDA call stays on one thread, while the
    handoff queue plus ``depth`` copies in flight still overlap producer
    IO, the copy engine and compute.
    """

    _DONE = object()

    def __init__(self, depth: int = 2, maxsize: int = 4, *,
                 device: Optional[torch.device | str] = None):
        self._q: _queue.Queue = _queue.Queue(maxsize=maxsize)
        self._pipe = IngestPipe(depth=depth, device=device)

    def put(self, arr: np.ndarray, timeout: Optional[float] = None) -> None:
        """Enqueue one host chunk. The chunk is COPIED here: staging
        happens later on the consumer thread, so without the copy a
        producer that recycles its buffer (the RingBuffer shape) could
        mutate a chunk before it is staged."""
        self._q.put(np.array(arr, copy=True), timeout=timeout)

    def close(self) -> None:
        """Signal end-of-stream; the consumer iterator then drains and stops."""
        self._q.put(self._DONE)

    def __iter__(self) -> Iterator[torch.Tensor]:
        def host_iter():
            while True:
                item = self._q.get()
                if item is self._DONE:
                    return
                yield item
        return self._pipe.stream(host_iter())

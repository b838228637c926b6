"""The band from a capture: the port's own server loop,
``radiocore_tpu_torch.apps.multi_fm_server.serve_fused``, replaying a
cf32 capture of the pool through ``IQFileSource`` (looping), with ZeroMQ
off and the app's own depth-2 ``IngestPipe``.

A publisher stand-in takes each station's bytes as a ZeroMQ PUB socket is
handed them; a timer keeps every stage call; a source wrapper stamps each
read. ``serve_fused`` builds and captures its step inside the call, so
the warm-up chunks run in the same call before the window, and the
window counts the chunks whose read began inside it. Each of them is
published before the wrapper ends the call (by raising at a later
read): with the pipe two deep, the read of chunk ``i + 2`` begins after
chunk ``i`` is published.

Closed loop: how fast a recorded band is replayed and published, which
is what a live server pays out of its one-second budget.
"""

from __future__ import annotations

import contextlib
import os
import random
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import signals
from portbench.trace import Tracer

BASE_HZ = 97_100_000      # the band's centre: its stations on odd tenths of MHz
APP_DEEMPHASIS_S = 75e-6  # serve_fused builds its step with the default
WARMUP_CHUNKS = 4         # before the window: build, capture, settle
SAMPLE_CHUNKS = 12        # published chunks drawn from the seed
TRACE_CHUNKS = 6          # traced after the window


class WindowClosed(Exception):
    """Raised from a read to end ``serve_fused`` once the window closed."""


class Timer:
    """``StageTimer``'s ``stage`` that keeps every call as ``(name, start,
    end)``; in a traced run each stage is also a profiler range."""

    def __init__(self, named: bool):
        from radiocore_tpu_torch.runtime.profiling import StageTimer
        self._inner = StageTimer()
        self.named = named
        self.calls: List = []

    @contextlib.contextmanager
    def stage(self, name, sync_value=None):
        rng = (torch.profiler.record_function(f"portbench.{name}")
               if self.named else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with rng, self._inner.stage(name, sync_value):
                yield
        finally:
            self.calls.append((name, t0, time.perf_counter()))


class Window:
    """The source wrapper: stamps each read, opens the window at read
    ``warmup``, closes it ``seconds`` later, and ends the call; in a
    traced run it first traces ``trace_chunks`` more chunks."""

    def __init__(self, source, warmup: int, seconds: float,
                 trace_chunks: int, tracer: Optional[Tracer]):
        self.source = source
        self.warmup = warmup
        self.seconds = seconds
        self.trace_chunks = trace_chunks
        self.tracer = tracer
        self.starts: List[float] = []
        self.end: Optional[float] = None
        self.closed_at: Optional[int] = None   # first read after the end
        self.summary = None

    def counted(self, i: int) -> bool:
        return (i >= self.warmup and self.end is not None
                and self.starts[i] < self.end)

    def read_chunk(self, seconds: float = 1.0):
        i = len(self.starts)
        now = time.perf_counter()
        if i == self.warmup:
            self.end = now + self.seconds
        elif self.end is not None and now >= self.end and self.closed_at is None:
            self.closed_at = i
        if self.closed_at is not None and i > self.closed_at:
            after = i - self.closed_at
            if self.tracer is None:
                raise WindowClosed
            if after == 1:
                self.tracer.start()
            elif after == 2:
                self.tracer.mark()
            elif after == 2 + self.trace_chunks:
                self.tracer.mark()
                self.summary = self.tracer.stop()
                raise WindowClosed
        self.starts.append(now)
        return self.source.read_chunk(seconds)


class Publisher:
    """A ZeroMQ PUB stand-in: ``send_multipart([topic, audio bytes])``,
    one call a station, in station order. Keeps the time each chunk's
    last station was handed over, and the audio of the last counted
    chunk and of a sample of them drawn from the seed."""

    def __init__(self, topics: List[bytes], window: Window, seed: int,
                 keep: int):
        self.topics = topics
        self.window = window
        self.rng = random.Random(seed)
        self.keep = keep
        self.parts: List[bytes] = []
        self.done: List[float] = []
        self.failed = 0
        self.sample: List = []
        self.last = None
        self.seen = 0

    def send_multipart(self, frames) -> None:
        topic, payload = frames
        if topic != self.topics[len(self.parts)]:
            self.failed += 1
        self.parts.append(payload)
        if len(self.parts) < len(self.topics):
            return
        i = len(self.done)
        self.done.append(time.perf_counter())
        parts, self.parts = self.parts, []
        if not self.window.counted(i):
            return
        out = (i, parts)
        self.last = out
        if self.seen < self.keep:
            self.sample.append(out)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.keep:
                self.sample[j] = out
        self.seen += 1


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, clock0: float) -> Dict:
    from radiocore_tpu_torch.apps.iq import IQFileSource
    from radiocore_tpu_torch.apps.multi_fm_server import (StationSpec,
                                                          serve_fused)

    if float(config["deemphasis_s"]) != APP_DEEMPHASIS_S:
        raise ValueError("serve_fused de-emphasises at 75 us only")
    c, sc = int(config["stations"]), int(config["station_rate"])
    n, m = int(config["band_rate"]), int(config["audio_rate"])
    pool = signals.band_pool(seed, config, traffic, device)
    chunks = pool.shape[0]
    tmp = tempfile.mkdtemp(prefix="portbench-")
    path = os.path.join(tmp, "band.cf32")
    try:
        with open(path, "wb") as f:
            pool.cpu().numpy().tofile(f)
            f.flush()
            # On disk before the window: the kernel's write-back of a
            # dirty capture would otherwise land inside some windows.
            os.fsync(f.fileno())
        del pool
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        specs = [StationSpec(BASE_HZ + o, "wbfm", sc)
                 for o in signals.offsets(config)]
        topics = [int(s.frequency).to_bytes(4, "little") for s in specs]
        warmup = WARMUP_CHUNKS
        window = Window(IQFileSource(path, n, "cf32"), warmup, seconds,
                        TRACE_CHUNKS, Tracer(device) if trace else None)
        publisher = Publisher(topics, window, seed, SAMPLE_CHUNKS)
        timer = Timer(named=trace)
        try:
            serve_fused(specs, n, m, window, 1e12, publisher=publisher,
                        mode=config["mode"], timer=timer, device=device,
                        extract_demod=config["extract_demod"])
        except WindowClosed:
            pass
        else:
            raise RuntimeError("serve_fused returned before the window "
                               "closed")
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        record = _record(window, publisher, timer, c)
        record["setup_s"] = window.starts[warmup] - clock0
        record["memory_peak_bytes"] = peak
        record["outputs"] = [
            {"position": i % chunks,
             "audio": np.stack([np.frombuffer(b, np.float32).reshape(m, 2)
                                for b in parts])}
            for i, parts in {id(o): o for o in publisher.sample
                             + [publisher.last]}.values()]
        data = np.fromfile(path, np.complex64).reshape(chunks, n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    record["pool"] = lambda: torch.from_numpy(data).to(device)
    return record


def _record(window: Window, publisher: Publisher, timer: Timer,
            stations: int) -> Dict:
    w, close = window.warmup, window.closed_at
    count = close - w
    a, b = window.starts[w], window.starts[close]
    latencies = [publisher.done[i] - window.starts[i] for i in range(w, close)]
    sources = [t for t in timer.calls if t[0] == "source"]
    # The same window on the timer's own clock readings: its source
    # stage opens just before the wrapper stamps the read.
    lo, hi = sources[w][1], sources[close][1]
    inside = [t for t in timer.calls if lo <= t[1] < hi]

    def mean_ms(name):
        d = [t[2] - t[1] for t in inside if t[0] == name]
        return 1e3 * sum(d) / len(d) if d else None

    staged = sum(t[2] - t[1] for t in inside)
    record = {"loop": "serve_fused", "stations": stations, "chunks": count,
              "attempted": count, "failed": publisher.failed,
              "window_s": b - a, "latencies_s": latencies,
              "served": {"source_ms": mean_ms("source"),
                         "fetch_ms": mean_ms("fetch"),
                         "between_ms": 1e3 * ((hi - lo) - staged) / count}}
    if window.summary is not None:
        record["trace"] = window.summary
    return record

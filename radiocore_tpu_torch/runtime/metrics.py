"""Structured runtime counters; a copy of ``radiocore_tpu/runtime/metrics.py``.

The reference's observability is ``print`` statements: ring occupancy %
per DSP loop (reference: ``examples/multi_fm_server.py:92-93``) and
"overflow" warnings (reference: ``radiocore/tools/ringbuffer.py:113-114``).
This module replaces them with a small counter registry that tracks the
same signals plus realtime factor and per-stage timing.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict


class Metrics:
    """Thread-safe counter/gauge registry for the streaming runtime."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._t0 = time.monotonic()

    def incr(self, name: str, value: float = 1.0) -> None:
        """Add ``value`` to counter ``name`` (creates it at 0)."""
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        """Set gauge ``name`` to ``value`` (last-write-wins)."""
        with self._lock:
            self._gauges[name] = value

    def realtime_factor(self, seconds_of_signal: float) -> float:
        """Seconds of signal processed per wall-clock second since start."""
        wall = time.monotonic() - self._t0
        return seconds_of_signal / wall if wall > 0 else float("inf")

    def snapshot(self) -> Dict[str, float]:
        """Consistent point-in-time copy of all counters and gauges."""
        with self._lock:
            out = dict(self._counters)
            out.update(self._gauges)
            out["uptime_s"] = time.monotonic() - self._t0
            return out

    def __repr__(self) -> str:
        return f"Metrics({self.snapshot()})"

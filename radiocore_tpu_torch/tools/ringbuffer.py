"""Thread-safe circular sample buffer for host-side IQ ingest; a copy of
``radiocore_tpu/tools/ringbuffer.py`` over the port's own native ring.

Behavioral parity with reference ``radiocore/tools/ringbuffer.py:10-160``:

* non-blocking ``put`` with overflow policy = optional print + whole-buffer
  reset (reference: ringbuffer.py:109-116),
* blocking ``get`` with an Event + timeout that returns ``None`` on
  timeout and ``True`` on success (reference: ringbuffer.py:145-149),
* two-segment wraparound copies, ``occupancy``/``vacancy``/``capacity``,
  ``reset``.

Role: this is the host staging ring between the SDR reader thread and
the device pipeline. A C++ backend (:mod:`radiocore_tpu_torch.native`)
provides the same semantics with lock-free
copies for high-rate ingest; this pure-Python version is the portable
fallback and the behavioral reference.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import numpy as np


class RingBuffer:
    def __init__(self, capacity: Union[int, float], dtype: str = "complex64",
                 print_overflow: bool = True, allow_overflow: bool = True,
                 backend: str = "auto", cuda: bool = False):
        del cuda  # parity-only: host ring is always host memory here
        self._capacity = int(capacity)
        self._dtype = np.dtype(dtype)
        self._print_overflow = bool(print_overflow)
        self._allow_overflow = bool(allow_overflow)
        self._head = 0  # write position
        self._tail = 0  # read position
        self._occupancy = 0
        self._overflows = 0
        self._lock = threading.Lock()
        self._data_ready = threading.Event()

        self._native = None
        if backend in ("auto", "native"):
            try:
                from radiocore_tpu_torch.native import load_native_ring
                self._native = load_native_ring(
                    self._capacity * self._dtype.itemsize)
            except Exception:
                if backend == "native":
                    raise
        self._ring = (np.zeros(0, dtype=self._dtype) if self._native
                      else np.zeros(self._capacity, dtype=self._dtype))

    @property
    def capacity(self) -> int:
        """Total capacity in samples."""
        return self._capacity

    @property
    def backend(self) -> str:
        """'native' (C++ lock-free SPSC copies) or 'python'."""
        return "native" if self._native is not None else "python"

    @property
    def occupancy(self) -> int:
        """Samples currently readable."""
        if self._native is not None:
            return self._native.occupancy_bytes // self._dtype.itemsize
        with self._lock:
            return self._occupancy

    @property
    def vacancy(self) -> int:
        """Samples writable before overflow."""
        return self.capacity - self.occupancy

    @property
    def overflows(self) -> int:
        """Count of overflow-reset events since construction (the
        streaming-health counter the sustained-run artifact reports)."""
        return self._overflows

    @property
    def data(self) -> np.ndarray:
        """Raw backing array (use with care).

        Only meaningful on the python backend; the native backend's
        storage lives in C++ and returns an empty array here.
        """
        return self._ring

    def reset(self) -> None:
        """Drop all buffered samples (the overflow recovery path)."""
        if self._native is not None:
            self._native.reset()
            return
        with self._lock:
            self._head = self._tail = 0
            self._occupancy = 0

    def __str__(self) -> str:
        return str(self._ring)

    def put(self, buffer) -> None:
        """Copy all of ``buffer`` into the ring (non-blocking).

        On overflow: raises when ``allow_overflow=False``; otherwise
        optionally prints "overflow" and hard-resets the whole ring before
        writing (reference: ringbuffer.py:109-116).
        """
        size = len(buffer)
        if size > self._capacity:
            raise ValueError("Input buffer is bigger than ring capacity.")

        if self._native is not None:
            src = np.ascontiguousarray(buffer, dtype=self._dtype)
            if self._native.put_bytes(src) != 1:
                if not self._allow_overflow:
                    raise ValueError("Overflow happened.")
                self._overflows += 1
                if self._print_overflow:
                    print("overflow")
                self._native.reset()
                self._native.put_bytes(src)
            self._data_ready.set()
            return

        with self._lock:
            if size > self._capacity - self._occupancy:
                if not self._allow_overflow:
                    raise ValueError("Overflow happened.")
                self._overflows += 1
                if self._print_overflow:
                    print("overflow")
                self._head = self._tail = 0
                self._occupancy = 0

            first = min(size, self._capacity - self._head)
            self._ring[self._head:self._head + first] = buffer[:first]
            if first < size:
                self._ring[:size - first] = buffer[first:]
            self._head = (self._head + size) % self._capacity
            self._occupancy += size

        self._data_ready.set()

    def get(self, buffer, timeout: float = 3.0) -> Optional[bool]:
        """Fill ``buffer`` from the ring, blocking until enough samples.

        Returns ``True`` on success, ``None`` if the timeout elapses while
        waiting (the caller's loop just retries — reference:
        ringbuffer.py:145-149, examples/receive_fm.py:97-98).
        """
        size = len(buffer)
        if size > self._capacity:
            raise ValueError("Input buffer is bigger than ring capacity.")

        if self._native is not None:
            out = buffer if (isinstance(buffer, np.ndarray)
                             and buffer.dtype == self._dtype
                             and buffer.flags["C_CONTIGUOUS"]) else None
            tmp = out if out is not None else np.empty(size, self._dtype)
            while self._native.get_bytes(tmp) != 1:
                if not self._data_ready.wait(timeout):
                    return None
                self._data_ready.clear()
            if out is None:
                buffer[:size] = tmp
            return True

        while True:
            with self._lock:
                if size <= self._occupancy:
                    break
            if not self._data_ready.wait(timeout):
                return None
            self._data_ready.clear()

        with self._lock:
            first = min(size, self._capacity - self._tail)
            buffer[:first] = self._ring[self._tail:self._tail + first]
            if first < size:
                buffer[first:] = self._ring[:size - first]
            self._tail = (self._tail + size) % self._capacity
            self._occupancy -= size
        return True

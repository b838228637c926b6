"""Fixed-slot recycling queue over pre-allocated items; a copy of
``radiocore_tpu/tools/carrousel.py``.

Behavioral parity with reference ``radiocore/tools/carrousel.py:9-118``:
slots are never freed — enqueue/dequeue context managers yield slot
references; overflow on a full enqueue advances the read head, drops the
oldest item and bumps the overflow counter (reference: carrousel.py:84-90);
``Buffer`` items are unwrapped via ``consume()``
(reference: carrousel.py:94-98). Single-producer only.

Role: the slot items are typically device tensors (or
:class:`~radiocore_tpu_torch.tools.buffer.Buffer` with ``device=True``),
giving zero-realloc recycling of staged chunks.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List

from radiocore_tpu_torch.tools.buffer import Buffer


class Carrousel:
    def __init__(self, items: List, print_overflow: bool = True):
        self._items = list(items)
        self._capacity = len(self._items)
        self._print_overflow = bool(print_overflow)
        self._read = 0    # next slot to dequeue
        self._write = 0   # next slot to enqueue
        self._occupancy = 0
        self._overflow = 0

    @property
    def occupancy(self) -> int:
        """Slots currently filled."""
        return self._occupancy

    @property
    def capacity(self) -> int:
        """Total slots."""
        return self._capacity

    @property
    def is_empty(self) -> bool:
        """True when no slot is filled."""
        return self._occupancy == 0

    @property
    def is_full(self) -> bool:
        """True when every slot is filled."""
        return self._occupancy >= self._capacity

    @property
    def overflow(self) -> int:
        """Count of overwrites of unread slots (head advanced)."""
        return self._overflow

    @property
    def is_healthy(self) -> bool:
        """True when at least one item is safe to read (reference: carrousel.py:62-69)."""
        return self._occupancy >= 1

    def reset(self) -> None:
        """Empty all slots and clear the overflow counter."""
        self._read = self._write = 0
        self._occupancy = 0

    def __str__(self) -> str:
        return str(self._items)

    @contextmanager
    def _yield_item(self, index: int):
        item = self._items[index]
        if isinstance(item, Buffer):
            with item.consume() as raw:
                yield raw
        else:
            yield item

    @contextmanager
    def enqueue(self):
        """Yield the next write slot; on overflow drop the oldest item."""
        if self.is_full:
            self._overflow += 1
            self._occupancy -= 1
            self._read = (self._read + 1) % self._capacity
            if self._print_overflow:
                print("overflow")
        try:
            with self._yield_item(self._write) as raw:
                yield raw
        finally:
            self._occupancy += 1
            self._write = (self._write + 1) % self._capacity

    @contextmanager
    def dequeue(self):
        """Yield the oldest enqueued slot for reading."""
        if self.is_empty:
            raise ValueError("carrousel is empty")
        try:
            with self._yield_item(self._read) as raw:
                yield raw
        finally:
            self._occupancy -= 1
            self._read = (self._read + 1) % self._capacity

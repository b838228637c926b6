"""Equal-chunk array slicer; a copy of ``radiocore_tpu/tools/chopper.py``.

Parity with reference ``radiocore/tools/chopper.py:6-55``: errors unless
evenly divisible, yields views not copies. ``chop_batch`` reshapes to
``(n_chunks, chunk)`` in one op, the natural form to feed a batched step.
Works on NumPy arrays and tensors alike.
"""

from __future__ import annotations

from typing import Union


class Chopper:
    def __init__(self, size: Union[int, float], chunk_size: Union[int, float]):
        self._size = int(size)
        self._chunk_size = int(chunk_size)
        if self._size % self._chunk_size != 0:
            raise ValueError(
                "cannot evenly divide array by chunk size "
                f"({self._size}, {self._chunk_size})")

    @property
    def size(self) -> int:
        """Total samples in the wrapped buffer."""
        return self._size

    @property
    def chunk_size(self) -> int:
        """Samples per chop."""
        return self._chunk_size

    @property
    def n_chunks(self) -> int:
        """Number of chunks the buffer divides into."""
        return self._size // self._chunk_size

    def chop(self, input_arr):
        """Yield successive chunk views of ``input_arr``."""
        for i in range(self.n_chunks):
            yield input_arr[i * self._chunk_size:(i + 1) * self._chunk_size]

    def chop_batch(self, input_arr):
        """Return all chunks at once as a ``(n_chunks, chunk_size)`` view."""
        return input_arr[:self._size].reshape(self.n_chunks, self._chunk_size)

    @staticmethod
    def get_to_da_choppa() -> str:
        """Easter-egg parity (reference: chopper.py:52-55)."""
        return "https://www.youtube.com/watch?v=Xs_OacEq2Sk"

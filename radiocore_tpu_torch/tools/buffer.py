"""Fixed-size staging buffer, host or device resident; counterpart of
``radiocore_tpu/tools/buffer.py``.

Parity surface with reference ``radiocore/tools/buffer.py:10-93``
(``data``, ``consume()``, ``size``, ``dtype``, ``is_locked``). A host
buffer is a NumPy array. ``device=True`` (or ``cuda=True``) puts it on
the card as a tensor; ``device=`` also takes a device, such as ``"cpu"``,
for a tensor there. A tensor is mutable, so ``consume()`` yields the
tensor itself and writes to it persist with no staging copy.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Union

import numpy as np
import torch

from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.transfer import as_torch_dtype


class Buffer:
    def __init__(self, size: Union[int, float], dtype: str = "complex64",
                 lock: bool = False,
                 device: Union[bool, str, torch.device] = False,
                 cuda: bool = False):
        self._size = int(size)
        self._mtx = threading.Lock() if lock else None
        if device is False and not cuda:
            self._array = np.zeros(self._size, dtype=np.dtype(dtype))
        else:
            # True (or cuda=True): the card; otherwise the device named.
            where = resolve_device(None if device in (True, False)
                                   else device)
            self._array = torch.zeros(self._size, dtype=as_torch_dtype(dtype),
                                      device=where)

    @property
    def dtype(self):
        """Element dtype (a NumPy dtype on the host, a torch dtype on a
        device)."""
        return self._array.dtype

    @property
    def size(self) -> int:
        """Element count."""
        return self._size

    def __len__(self) -> int:
        return self._size

    @property
    def is_device(self) -> bool:
        """True when the storage is a tensor."""
        return isinstance(self._array, torch.Tensor)

    @property
    def is_cuda(self) -> bool:
        """True when the storage is a tensor on a CUDA device."""
        return self.is_device and self._array.is_cuda

    @property
    def is_locked(self) -> bool:
        """True while a consume() view is outstanding."""
        if self._mtx is None:
            raise ValueError("locking is not enabled in this instance")
        return self._mtx.locked()

    @property
    def data(self):
        return self._array

    @data.setter
    def data(self, value):
        self._array = value

    @contextmanager
    def consume(self):
        """Yield the storage itself (a NumPy array or a tensor); writes
        persist after the context exits (the reference contract,
        reference: ``tests/test_buffer.py:8-30``)."""
        if self._mtx is None:
            yield self._array
            return
        with self._mtx:
            yield self._array

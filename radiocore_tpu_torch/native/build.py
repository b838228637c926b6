"""On-demand compilation and ctypes binding of the port's host C++
components; counterpart of ``radiocore_tpu/native/build.py``.

``ringbuffer.cpp`` and ``iqconvert.cpp`` beside this file are the port's
own copies of the JAX package's sources. Each is compiled with the
system C++ compiler at first use, never at import, into
``radiocore_tpu_torch/_build/native/<hash>/`` in a checkout, or under
``~/.cache/radiocore_tpu_torch/native/<hash>/`` where the package's
directory cannot be written (an installed wheel), keyed by a hash of the
source and the flags, so the two packages never share a library. Where
a source is missing or no compiler works the loaders return None and
every consumer runs its pure Python or NumPy version: host code, as in
the reference.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "ringbuffer.cpp"
_IQ_SRC = _HERE / "iqconvert.cpp"
BUILD_DIR = _HERE.parent / "_build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build_dir() -> Path:
    """:data:`BUILD_DIR` where the package's directory can be written (a
    checkout), else a per-user cache (an installed wheel)."""
    if os.access(_HERE.parent, os.W_OK):
        return BUILD_DIR
    return Path.home() / ".cache" / "radiocore_tpu_torch" / "native"


def _lib_path(src: Path, name: str) -> Optional[Path]:
    """Where ``src``'s library goes; None when the source is missing."""
    try:
        code = src.read_bytes()
    except FileNotFoundError:
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(code)
    return build_dir() / h.hexdigest()[:16] / name


def _compile(src: Path, name: str) -> Optional[Path]:
    """The built library of ``src``, compiled now if it is not there yet;
    None when the source is missing or no C++ compiler builds it."""
    path = _lib_path(src, name)
    if path is None:
        return None
    if path.exists():
        return path
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    for cxx in ("g++", "c++", "clang++"):
        # Build to a temp file, then rename it into place, so that
        # concurrent processes never load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
        os.close(fd)
        try:
            subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
            return path
        except (OSError, subprocess.SubprocessError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return None


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    path = _compile(_SRC, "libradiocore_ring.so")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.rc_ring_create.restype = ctypes.c_void_p
    lib.rc_ring_create.argtypes = [ctypes.c_size_t]
    lib.rc_ring_destroy.restype = None
    lib.rc_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rc_ring_capacity.restype = ctypes.c_size_t
    lib.rc_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.rc_ring_occupancy.restype = ctypes.c_size_t
    lib.rc_ring_occupancy.argtypes = [ctypes.c_void_p]
    lib.rc_ring_reset.restype = None
    lib.rc_ring_reset.argtypes = [ctypes.c_void_p]
    lib.rc_ring_put.restype = ctypes.c_int
    lib.rc_ring_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t]
    lib.rc_ring_get.restype = ctypes.c_int
    lib.rc_ring_get.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t]
    return lib


def native_available() -> bool:
    """True when the native ring compiled and loaded on this machine."""
    return _load() is not None


class NativeRing:
    """ctypes handle to one C++ SPSC byte ring."""

    def __init__(self, capacity_bytes: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native ring unavailable (no C++ toolchain)")
        self._lib = lib
        self._handle = lib.rc_ring_create(capacity_bytes)
        if not self._handle:
            raise MemoryError("rc_ring_create failed")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.rc_ring_destroy(handle)
            self._handle = None

    @property
    def occupancy_bytes(self) -> int:
        """Bytes currently readable."""
        return self._lib.rc_ring_occupancy(self._handle)

    def reset(self) -> None:
        """Drop all buffered bytes (the overflow semantics hook)."""
        self._lib.rc_ring_reset(self._handle)

    def put_bytes(self, buf) -> int:
        """Copy ``buf`` (a C-contiguous array, ``bytes`` or ``bytearray``)
        in without blocking: 1 when it fit, 0 when there was no room, -1
        when it exceeds the capacity."""
        if isinstance(buf, (bytes, bytearray)):
            buf = np.frombuffer(buf, np.uint8)
        return self._lib.rc_ring_put(self._handle, buf.ctypes.data,
                                     buf.nbytes)

    def get_bytes(self, out: np.ndarray) -> int:
        """Fill the C-contiguous array ``out`` without blocking: 1 when
        enough bytes were buffered, 0 when not, -1 when it exceeds the
        capacity."""
        return self._lib.rc_ring_get(self._handle, out.ctypes.data,
                                     out.nbytes)


def load_native_ring(capacity_bytes: int) -> NativeRing:
    """Build (once) and load the C++ SPSC ring via ctypes."""
    return NativeRing(capacity_bytes)


# ---------------------------------------------------------------------------
# IQ sample-format conversion (iqconvert.cpp)
# ---------------------------------------------------------------------------

_IQ_FUNCS = {"cu8": ("rc_iq_u8_to_f32", ctypes.c_uint8, np.uint8),
             "cs8": ("rc_iq_s8_to_f32", ctypes.c_int8, np.int8),
             "cs16": ("rc_iq_s16_to_f32", ctypes.c_int16, np.int16)}


@functools.lru_cache(maxsize=1)
def _load_iq() -> Optional[ctypes.CDLL]:
    path = _compile(_IQ_SRC, "libradiocore_iq.so")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    for name, src_t, _ in _IQ_FUNCS.values():
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(src_t), ctypes.POINTER(ctypes.c_float),
                       ctypes.c_size_t]
    lib.rc_iq_f32_to_s16.restype = None
    lib.rc_iq_f32_to_s16.argtypes = [ctypes.POINTER(ctypes.c_float),
                                     ctypes.POINTER(ctypes.c_int16),
                                     ctypes.c_size_t]
    return lib


def iq_native_available() -> bool:
    """True when the native IQ converter compiled and loaded."""
    return _load_iq() is not None


def iq_convert_native(raw: np.ndarray, fmt: str) -> Optional[np.ndarray]:
    """Convert raw interleaved IQ scalars to float32 with the C++ loops.

    ``raw`` is a 1-D NumPy array of the wire dtype (u8/s8/s16); returns a
    float32 array of the same length, or None when the native library is
    unavailable (the caller then converts with NumPy).
    """
    lib = _load_iq()
    if lib is None:
        return None
    name, src_t, np_t = _IQ_FUNCS[fmt]
    if raw.dtype != np_t:
        raise TypeError(f"{fmt} expects dtype {np.dtype(np_t)}, "
                        f"got {raw.dtype}")
    raw = np.ascontiguousarray(raw)
    out = np.empty(raw.shape, np.float32)
    getattr(lib, name)(
        raw.ctypes.data_as(ctypes.POINTER(src_t)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        raw.size)
    return out


def iq_f32_to_s16_native(f32: np.ndarray) -> Optional[np.ndarray]:
    """float32 → int16 quantize (recording path); None if unavailable."""
    lib = _load_iq()
    if lib is None:
        return None
    f32 = np.ascontiguousarray(f32, np.float32)
    out = np.empty(f32.shape, np.int16)
    lib.rc_iq_f32_to_s16(
        f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        f32.size)
    return out

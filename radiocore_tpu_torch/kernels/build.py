"""Build the port's CUDA sources (``csrc/*.cu``) with ``nvcc`` and load them.

All kernels go into ONE shared library with a plain C interface, bound
with :mod:`ctypes` (no PyTorch headers, so the build takes seconds). Each
source compiles in its own ``nvcc`` process, all started together, and
one more links the objects. The library lands in
``radiocore_tpu_torch/_build/<hash>/``, keyed by a hash of the sources
and flags, and is built at first use. A failed build raises with
``nvcc``'s own error output.

Nothing here runs at import time: the CPU tests import every module of
the port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libradiocore_kernels.so"

# sm_90a: Hopper with its architecture-specific features. No
# --use_fast_math: __sinf/__cosf lose digits on twiddle and window phases.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc/ptxas output of the build that made it


def sources() -> List[Path]:
    return sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                           "CUDA toolkit (nvcc on PATH or /usr/local/cuda)")
    return path


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands at once; their joined output, or raise with it."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(outs)
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return log


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into the keyed build directory (once)."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildResult(lib, 0.0, log)
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        cu = [s for s in sources() if s.suffix == ".cu"]
        objs = [str(work / f"{src.stem}.o") for src in cu]
        t0 = time.perf_counter()
        log = _run_all([[nvcc, *COMPILE_FLAGS, "-I", str(CSRC_DIR), "-c",
                         "-o", obj, str(src)] for src, obj in zip(cu, objs)])
        tmp = str(work / LIB_NAME)
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]])
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return BuildResult(lib, seconds, log)


_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# Argument types of every C entry point in csrc/ (pointers and the
# stream as void*, so ctypes never truncates them to 32 bits).
_SIGNATURES = {
    "rc_fft_pass": [_P, _P, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                    _L, _L, _I, _P],
    "rc_l2_cache_bytes": [_P],
    "rc_extract_rows": [_P, _P, _P, _P, _I, _L, _L, _I, _L, _L, _L, _F, _P,
                        _P],
    "rc_extract_gather": [_P, _P, _P, _P, _L, _L, _L, _F, _P],
    "rc_extract_demod": [_P, _P, _P, _P, _P, _L, _L, _I, _L, _L, _L, _F, _L,
                         _P, _P],
    "rc_atan2_fast": [_P, _P, _P, _L, _P],
    "rc_fir": [_P, _L, _P, _L, _P, _P, _L, _L, _I, _P],
    "rc_rfft_untangle": [_P, _P, _L, _I, _P],
    "rc_irfft_tangle": [_P, _P, _L, _I, _P],
    "rc_mixed_column": [_P, _P, _I, _L, _I, _P, _P],
    "rc_nco_pll": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _F,
                   _F, _F, _F, _I, _P],
    "rc_nco_chain_probe": [_P, _P, _L, _I, _I, _I, _F, _F, _F, _F, _P],
    "rc_quad_demod": [_P, _L, _P, _L, _L, _F, _P],
    "rc_fft_band": [_P, _P, _P, _L, _I, _I, _I, _P, _P, _P],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build().path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")

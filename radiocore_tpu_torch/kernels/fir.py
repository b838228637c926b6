"""K-FIR: direct causal real FIR with carried history, hand-written for
Hopper.

Counterpart of ``radiocore_tpu/kernels/fir_pallas.py``
(``fir_causal_pallas``): ``y[n] = Σ_k taps[k]·x[n−k]`` along the last
axis, with ``history`` as the ``T−1`` samples before ``x`` (zeros when
None). The kernel (``csrc/fir.cu``) sums in float32 FMAs, with no TF32
and no tensor cores: each thread computes :data:`OUTPUTS_PER_THREAD`
consecutive outputs over a window of ``x`` that it keeps in registers,
the taps going by in chunks of :data:`TAP_CHUNK`; a block stages
:data:`TILE` samples of a row and a halo of :func:`staged_chunks` whole
chunks in shared memory, laid out by :func:`skew`.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs
:func:`fir_causal_plain`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from radiocore_tpu_torch.kernels.fft_rows import LaunchCounter
from radiocore_tpu_torch.ops.consts import device_array

MAX_TAPS = 4096
# The geometry of csrc/fir.cu (kR, kC, kThreads, kTile).
OUTPUTS_PER_THREAD = 8
TAP_CHUNK = 8
THREADS = 256
TILE = THREADS * OUTPUTS_PER_THREAD

launches = LaunchCounter()


def fir_causal_plain(x: torch.Tensor, taps,
                     history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: shift-and-add over the taps in ``x``'s dtype
    (complex ``x`` filters I and Q alike)."""
    taps = np.asarray(taps, dtype=np.float64)
    t = len(taps)
    n = x.shape[-1]
    if history is None:
        history = torch.zeros(x.shape[:-1] + (t - 1,), dtype=x.dtype,
                              device=x.device)
    xp = torch.cat([history.to(x.dtype), x], dim=-1)
    tp = device_array(taps, x.device, x.real.dtype)
    y = torch.zeros_like(x)
    for k in range(t):
        y += tp[k] * xp[..., t - 1 - k:t - 1 - k + n]
    return y


def staged_chunks(num_taps: int) -> int:
    """Chunks of :data:`TAP_CHUNK` that cover the taps (zero padded) and,
    as samples, the halo staged in front of a tile."""
    return -(-num_taps // TAP_CHUNK)


def skew(i: int) -> int:
    """Shared-memory position of sample ``i`` of a staged tile: 4 floats
    of padding after every :data:`OUTPUTS_PER_THREAD` samples, so that the
    16-byte loads of a quarter-warp fall on distinct banks."""
    return i + (i // OUTPUTS_PER_THREAD) * 4


def smem_bytes(num_taps: int) -> int:
    """Dynamic shared memory of a block: padded taps and skewed tile."""
    halo = staged_chunks(num_taps) * TAP_CHUNK
    return 4 * (halo + skew(halo + TILE))


def _rows(t: torch.Tensor, width: int, what: str) -> torch.Tensor:
    """2-D (rows, width) view with unit stride along the last axis."""
    t2 = t.reshape(-1, width)
    if t2.stride(-1) != 1 and width > 1:
        raise ValueError(f"fir_causal_rows: {what} needs unit stride along "
                         f"its last axis")
    return t2


def _fir_kernel(x: torch.Tensor, taps: np.ndarray,
                history: Optional[torch.Tensor]) -> torch.Tensor:
    from radiocore_tpu_torch.kernels import build
    if x.dtype != torch.float32:
        raise TypeError(f"fir_causal_rows: kernel takes float32, got {x.dtype}")
    t = len(taps)
    if not 1 <= t <= MAX_TAPS:
        raise ValueError(f"fir_causal_rows: {t} taps (kernel takes 1.."
                         f"{MAX_TAPS})")
    n = int(x.shape[-1])
    x2 = _rows(x, n, "x")
    rows = x2.shape[0]
    hist_ptr, hist_stride = None, 0
    if history is not None and t > 1:
        if (not history.is_cuda or history.dtype != torch.float32
                or tuple(history.shape) != tuple(x.shape[:-1]) + (t - 1,)):
            raise ValueError(
                f"fir_causal_rows: history must be float32 CUDA of shape "
                f"{tuple(x.shape[:-1]) + (t - 1,)}, got {history.dtype} "
                f"{tuple(history.shape)} on {history.device}")
        h2 = _rows(history, t - 1, "history")
        hist_ptr, hist_stride = h2.data_ptr(), h2.stride(0)
    tp = device_array(taps.astype(np.float32), x.device)
    lib = build.library()
    y = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    err = lib.rc_fir(x2.data_ptr(), x2.stride(0), hist_ptr, hist_stride,
                     tp.data_ptr(), y.data_ptr(), rows, n, t,
                     torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_fir(T={t}, n={n})")
    launches.count += 1
    return y.reshape(x.shape)


def fir_causal_rows(x: torch.Tensor, taps,
                    history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal FIR along the last axis with any leading batch dims;
    the kernel on CUDA, :func:`fir_causal_plain` on the CPU."""
    taps = np.asarray(taps, dtype=np.float64)
    if x.is_cuda:
        return _fir_kernel(x, taps, history)
    if x.device.type != "cpu":
        raise ValueError(f"fir_causal_rows: no kernel for {x.device}")
    return fir_causal_plain(x, taps, history)

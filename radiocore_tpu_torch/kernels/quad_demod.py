"""K-QDEMOD: the quadrature (FM) demod of complex64 rows in one pass,
hand-written for Hopper.

``quad[0] = 0`` and ``quad[t] = gain · angle(0 + x[t]·conj(x[t−1]))``
along the last axis, as :func:`quad_demod_plain` computes it. The kernel
(``csrc/quad_demod.cu``) replaces no TPU kernel: the reference's demod is
jnp ops (``radiocore_tpu/ops/demod.py``). It reads each IQ point once and
writes each quad sample once; a thread takes :data:`SAMPLES` consecutive
samples by 16-byte loads where every row is 16-byte aligned
(:func:`vectorised`), by 8-byte loads otherwise, and the predecessor of
its first sample from the lane before it.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs
:func:`quad_demod_plain` (``ops/demod.quadrature_demod``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from radiocore_tpu_torch.kernels.fft_rows import LaunchCounter

# The geometry of csrc/quad_demod.cu (kThreads, kSamples, kTile).
THREADS = 256
SAMPLES = 4
TILE = THREADS * SAMPLES

launches = LaunchCounter()


def quad_demod_plain(iq: torch.Tensor,
                     gain: Optional[float] = None) -> torch.Tensor:
    """Plain version: the product onto +0 in one ``addcmul``, its
    ``angle``, the gain, and the first sample 0."""
    d = torch.addcmul(iq.new_zeros(()), iq[..., 1:],
                      torch.conj(iq[..., :-1]))
    ph = torch.angle(d) * (1.0 / math.pi if gain is None else gain)
    return F.pad(ph, (1, 0))


def vectorised(x_ptr: int, x_stride: int, rows: int, n: int,
               y_ptr: int = 0) -> bool:
    """Whether ``rc_quad_demod`` takes its 16-byte path: every input row
    and every output row starts on a 16-byte boundary and a row is whole
    groups of :data:`SAMPLES` (complex64 input, float32 output)."""
    return (x_ptr % 16 == 0 and y_ptr % 16 == 0
            and (rows == 1 or x_stride % 2 == 0) and n % SAMPLES == 0)


def blocks(rows: int, n: int) -> int:
    """Thread blocks of one launch: a flat grid of :data:`TILE` samples a
    block over every row."""
    return rows * -(-n // TILE)


def quad_demod_rows(iq: torch.Tensor,
                    gain: Optional[float] = None) -> torch.Tensor:
    """The kernel along the last axis of a complex64 CUDA tensor with any
    leading batch dims (unit stride along a row, any row stride); raises
    on what it does not take, before any launch."""
    if iq.dtype != torch.complex64:
        raise TypeError(f"quad_demod_rows: kernel takes complex64, got "
                        f"{iq.dtype}")
    if not iq.is_cuda:
        raise ValueError(f"quad_demod_rows: kernel takes a CUDA tensor, got "
                         f"one on {iq.device}")
    if iq.dim() < 1 or iq.numel() == 0:
        raise ValueError(f"quad_demod_rows: needs a row of at least one "
                         f"sample, got shape {tuple(iq.shape)}")
    if iq.is_conj():
        raise ValueError("quad_demod_rows: a lazy conj view (resolve it "
                         "first: the kernel reads the stored values)")
    n = int(iq.shape[-1])
    x = iq.reshape(-1, n)
    rows = x.shape[0]
    if x.stride(-1) != 1 and n > 1:
        raise ValueError("quad_demod_rows: needs unit stride along the "
                         "last axis")
    y = torch.empty((rows, n), dtype=torch.float32, device=iq.device)
    from radiocore_tpu_torch.kernels import build
    g = 1.0 / math.pi if gain is None else float(gain)
    err = build.library().rc_quad_demod(
        x.data_ptr(), x.stride(0), y.data_ptr(), rows, n, g,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_quad_demod(rows={rows}, n={n})")
    launches.count += 1
    return y.reshape(iq.shape)

"""Halo exchange for time-sharded filtering; counterpart of
``radiocore_tpu/parallel/halo.py``.

The sample axis is sharded over the ranks of a mesh axis. A causal FIR
needs the last ``num_taps−1`` samples of the left neighbour's block, a
zero-phase FIR halos on both sides; the streaming forms carry the
global tail as their state. The ``*_halo`` functions run on this rank's
block and an :class:`~radiocore_tpu_torch.parallel.collectives.Axis`, as
the reference's run inside ``shard_map``; :func:`fir_causal_sharded` and
:func:`zero_phase_fir_sharded` take the mesh and an axis name instead.

Each rank filters with the port's own single-device ops, so on a CUDA
block :func:`fir_causal_halo` is K-FIR with the left halo as its
history: the same sums, in the same order, as K-FIR on the whole signal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.ops.fir import fir_causal, fir_overlap_save
from radiocore_tpu_torch.ops.pfb import pfb_channelize
from radiocore_tpu_torch.parallel.collectives import Axis, ppermute, psum
from radiocore_tpu_torch.parallel.mesh import TIME, AxisName, RadioMesh
from radiocore_tpu_torch.runtime.routes import Routes


def _shift_right(block_tail: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Send each rank's tail to its right neighbour; rank 0 gets zeros."""
    return ppermute(block_tail, [(i, i + 1) for i in range(axis.size - 1)],
                    axis)


def _shift_left(block_head: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Send each rank's head to its left neighbour; the last gets zeros."""
    return ppermute(block_head, [(i + 1, i) for i in range(axis.size - 1)],
                    axis)


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    return x[..., x.shape[-1] - n:]


def halo_exchange(x: torch.Tensor, n_left: int, n_right: int,
                  axis: Axis) -> torch.Tensor:
    """Pad a time-sharded block with neighbour samples along the last
    axis: ``(..., n_left + block + n_right)``, zeros where no neighbour
    exists (callers overlay stream state at the global edges)."""
    parts = []
    if n_left > 0:
        parts.append(_shift_right(_tail(x, n_left), axis))
    parts.append(x)
    if n_right > 0:
        parts.append(_shift_left(x[..., :n_right], axis))
    return torch.cat(parts, dim=-1)


def fir_causal_halo(x: torch.Tensor, taps, axis: Axis,
                    routes: Optional[Routes] = None) -> torch.Tensor:
    """Causal FIR on a time-sharded block: the port's ``fir_causal`` with
    the left neighbour's tail as history (rank 0: zeros), equal to the
    unsharded ``fir_causal`` with zero history."""
    taps = np.asarray(taps, dtype=np.float64)
    t = len(taps)
    left = _shift_right(_tail(x, t - 1), axis) if t > 1 else None
    return fir_causal(x, taps, history=left, routes=routes)


def zero_phase_fir_halo(x: torch.Tensor, taps, axis: Axis,
                        routes: Optional[Routes] = None) -> torch.Tensor:
    """Zero-phase FIR on a time-sharded block: the forward-backward
    filter, a causal sweep with a left halo and an anti-causal one with a
    right halo. The global edges see zero padding, as in the reference
    (not scipy's odd extension): only the first and last ``3·num_taps``
    samples of the whole signal differ from ``filtfilt``."""
    taps = np.asarray(taps, dtype=np.float64)
    t = len(taps)
    if t == 1:
        return fir_causal(fir_causal(x, taps, routes=routes), taps,
                          routes=routes)
    fwd = fir_causal(x, taps, history=_shift_right(_tail(x, t - 1), axis),
                     routes=routes)
    right = _shift_left(fwd[..., :t - 1].contiguous(), axis)
    # The anti-causal sweep is the causal one on the reversed block, with
    # the reversed right halo as its history.
    bwd = fir_causal(torch.flip(fwd, dims=(-1,)), taps,
                     history=torch.flip(right, dims=(-1,)), routes=routes)
    return torch.flip(bwd, dims=(-1,))


def _history_or_left_halo(x: torch.Tensor, t_hist: int,
                          stream_history: Optional[torch.Tensor],
                          axis: Axis) -> torch.Tensor:
    """The left neighbour's tail on every rank; rank 0 takes the stream
    state instead, where one is given."""
    left = _shift_right(_tail(x, t_hist), axis)
    if stream_history is None or axis.index != 0:
        return left
    return stream_history.to(device=x.device, dtype=x.dtype).expand_as(left)


def _last_shard_tail(x: torch.Tensor, t_hist: int,
                     axis: Axis) -> torch.Tensor:
    """The global tail (the last rank's), on every rank (one psum)."""
    tail = _tail(x, t_hist)
    if axis.index != axis.size - 1:
        tail = torch.zeros_like(tail)
    return psum(tail, axis)


def fir_overlap_save_halo(x: torch.Tensor, taps, axis: Axis,
                          stream_history: Optional[torch.Tensor] = None,
                          block: int = 1 << 15,
                          routes: Optional[Routes] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming overlap-save FIR on a time-sharded block: each rank
    filters its block with its own FFTs, the only collectives being the
    tap-length halo and a psum of the carried state. Returns
    ``(y, new_history)``, equal to ``ops.fir.fir_overlap_save`` on the
    whole chunk with ``stream_history``."""
    t = len(np.asarray(taps))
    hist = _history_or_left_halo(x, t - 1, stream_history, axis)
    y = fir_overlap_save(x, taps, history=hist, block=block, routes=routes)
    return y, _last_shard_tail(x, t - 1, axis)


def pfb_channelize_halo(x: torch.Tensor, taps, n_channels: int, axis: Axis,
                        stream_history: Optional[torch.Tensor] = None,
                        routes: Optional[Routes] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming PFB channelizer on a time-sharded band: each rank
    channelizes its block with the left neighbour's ``(P−1)·M``-sample
    tail as history (the PFB's whole streaming state). Frames never
    straddle ranks when the block divides by ``n_channels``; the output's
    frame axis stays time-sharded. Returns ``(channels, new_history)``."""
    m = int(n_channels)
    p = len(np.asarray(taps)) // m
    t_hist = (p - 1) * m
    if x.shape[-1] % m:
        raise ValueError("local block must divide by n_channels")
    hist = _history_or_left_halo(x, t_hist, stream_history, axis)
    channels, _ = pfb_channelize(x, taps, m, history=hist, routes=routes)
    return channels, _last_shard_tail(x, t_hist, axis)


def fir_causal_sharded(x: torch.Tensor, taps, mesh: RadioMesh,
                       axis_name: AxisName = TIME,
                       routes: Optional[Routes] = None) -> torch.Tensor:
    """:func:`fir_causal_halo` on this rank's block of a signal whose
    last axis is sharded over ``axis_name`` (``mesh.shard`` cuts one
    from the whole signal)."""
    return fir_causal_halo(x, taps, mesh.axis(axis_name), routes)


def zero_phase_fir_sharded(x: torch.Tensor, taps, mesh: RadioMesh,
                           axis_name: AxisName = TIME,
                           routes: Optional[Routes] = None) -> torch.Tensor:
    """:func:`zero_phase_fir_halo` on this rank's block over
    ``axis_name``."""
    return zero_phase_fir_halo(x, taps, mesh.axis(axis_name), routes)

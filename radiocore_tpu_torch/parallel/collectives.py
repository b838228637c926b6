"""The collectives of the port's sharded code, on ``torch.distributed``.

The JAX package writes its sharded stages as ``shard_map`` bodies over a
named mesh axis and lets XLA lower ``lax.ppermute``, ``lax.all_to_all``
and ``lax.psum`` to collectives. Here each rank runs its body eagerly and
calls these functions on an :class:`Axis`, this rank's view of one axis
of a :class:`~radiocore_tpu_torch.parallel.mesh.RadioMesh`:

* :func:`ppermute`: a partial permutation of the axis; a rank that
  receives nothing gets zeros, as from ``lax.ppermute``;
* :func:`all_to_all`: the untiled ``lax.all_to_all``: piece ``q`` of
  ``split_axis`` goes to rank ``q``, and the pieces received are stacked,
  in source order, on a new axis at ``concat_axis``;
* :func:`psum`, :func:`all_gather`, :func:`axis_index`,
  :func:`axis_size`.

Complex tensors travel as ``view_as_real``. Under ``gloo`` a CUDA tensor
is staged through page-locked host memory and the result copied back
(:func:`_stage`): the choice is made by the axis's backend, before the
call, and never by retrying a failed call. ``nccl`` takes the card's
tensors as they are.

Every call adds to its mesh's :class:`CollectiveBytes`, under XLA's name
for the collective, the bytes of its result on this rank, as
``comm_analysis.collective_bytes`` reads them off compiled HLO in the
reference, and the seconds it took on the host's clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

class CollectiveBytes:
    """Bytes of the results and host seconds of this rank's collectives,
    by XLA's kind names, since the last :meth:`reset`.

    The seconds are the host's clock around each call. A call staged
    through host memory (``gloo`` with CUDA tensors) returns when its
    result is on the card, so there they are the collective's time; with
    ``nccl`` they are the time to enqueue it.
    """

    def __init__(self) -> None:
        self.bytes: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}

    def reset(self) -> None:
        self.bytes.clear()
        self.seconds.clear()

    def add(self, kind: str, nbytes: int, seconds: float) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: the global ranks along it in
    axis order, this rank's position, the process group of those ranks
    (None for an axis of one rank), the group's backend and the mesh's
    byte counter."""

    name: str
    ranks: Tuple[int, ...]
    index: int
    group: Optional[dist.ProcessGroup]
    backend: Optional[str]
    counter: CollectiveBytes

    @property
    def size(self) -> int:
        return len(self.ranks)


def axis_index(axis: Axis) -> int:
    """This rank's position along ``axis`` (``lax.axis_index``)."""
    return axis.index


def axis_size(axis: Axis) -> int:
    """The number of ranks along ``axis`` (``lax.axis_size``)."""
    return axis.size


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the real tensor that goes over the wire."""
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _stage(axis: Axis, x: torch.Tensor) -> bool:
    """Whether a call on ``axis`` carries ``x`` through host memory:
    ``gloo`` with a CUDA tensor."""
    return x.is_cuda and axis.backend == "gloo"


def _to_wire(axis: Axis, x: torch.Tensor) -> torch.Tensor:
    """The real tensor to send: a page-locked host copy where staged."""
    w = _wire(x)
    if not _stage(axis, x):
        return w
    host = torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
    host.copy_(w)
    return host


def _wire_buffer(axis: Axis, like: torch.Tensor,
                 shape: Sequence[int]) -> torch.Tensor:
    """An empty real receive buffer for a result of ``like``'s dtype and
    ``shape``, in host memory where staged."""
    real = like.real.dtype if like.is_complex() else like.dtype
    full = tuple(shape) + ((2,) if like.is_complex() else ())
    if _stage(axis, like):
        return torch.empty(full, dtype=real, pin_memory=True)
    return torch.empty(full, dtype=real, device=like.device)


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received real buffer as a tensor of ``like``'s dtype and
    device."""
    w = w.to(like.device)
    return torch.view_as_complex(w) if like.is_complex() else w


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             axis: Axis) -> torch.Tensor:
    """Send ``x`` along the ``(source, destination)`` pairs of ``perm``
    (axis positions, each at most once on either side); the result is
    what this rank receives, zeros if nothing."""
    src = [s for s, _ in perm]
    dst = [d for _, d in perm]
    if len(set(src)) != len(src) or len(set(dst)) != len(dst):
        raise ValueError(f"ppermute: {perm} is not a permutation")
    t0 = time.perf_counter()
    me = axis.index
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    if recv_from and recv_from[0] == me:
        out = x.clone()
    else:
        out = torch.zeros_like(x)
        ops: List[dist.P2POp] = []
        if send_to:
            ops.append(dist.P2POp(dist.isend, _to_wire(axis, x),
                                  axis.ranks[send_to[0]]))
        if recv_from:
            buf = _wire_buffer(axis, x, x.shape)
            ops.append(dist.P2POp(dist.irecv, buf, axis.ranks[recv_from[0]]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if recv_from:
            out = _from_wire(buf, x)
    axis.counter.add("collective-permute", _nbytes(x),
                     time.perf_counter() - t0)
    return out


def all_to_all(x: torch.Tensor, split_axis: int, concat_axis: int,
               axis: Axis) -> torch.Tensor:
    """The untiled ``lax.all_to_all``: ``x.shape[split_axis]`` equals the
    axis size; piece ``q`` (index ``q`` of ``split_axis``) goes to rank
    ``q``, and the result stacks the pieces received from ranks
    ``0 … D−1`` on a new axis at ``concat_axis``."""
    d = axis.size
    if x.shape[split_axis] != d:
        raise ValueError(f"all_to_all: split axis of {x.shape[split_axis]} "
                         f"on an axis of {d} ranks")
    t0 = time.perf_counter()
    pieces = x.movedim(split_axis, 0)           # (D, rest...): piece q
    if d == 1:
        out = pieces.clone()
    else:
        buf = _wire_buffer(axis, x, pieces.shape)
        dist.all_to_all_single(buf, _to_wire(axis, pieces), group=axis.group)
        out = _from_wire(buf, x)
    axis.counter.add("all-to-all", _nbytes(x), time.perf_counter() - t0)
    return out.movedim(0, concat_axis)


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, on every rank."""
    t0 = time.perf_counter()
    if axis.size == 1:
        out = x.clone()
    else:
        w = _to_wire(axis, x)
        if not _stage(axis, x):
            w = w.clone()                       # reduce into a copy
        dist.all_reduce(w, group=axis.group)
        out = _from_wire(w, x)
    axis.counter.add("all-reduce", _nbytes(x), time.perf_counter() - t0)
    return out


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape), stacked in axis order on a
    new leading axis, on every rank."""
    d = axis.size
    t0 = time.perf_counter()
    if d == 1:
        out = x.unsqueeze(0).clone()
    else:
        buf = _wire_buffer(axis, x, (d,) + tuple(x.shape))
        dist.all_gather(list(buf.unbind(0)), _to_wire(axis, x),
                        group=axis.group)
        out = _from_wire(buf, x)
    axis.counter.add("all-gather", d * _nbytes(x), time.perf_counter() - t0)
    return out

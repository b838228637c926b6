"""The ``(stations, time)`` rank mesh of the radio pipeline; counterpart
of ``radiocore_tpu/parallel/mesh.py``.

The port's mesh is a small class of its own, not
``torch.distributed.device_mesh.DeviceMesh``: it holds the grid of global
ranks, laid out row-major over ``(stations, time)`` as the reference
reshapes its device list, one process group per row and per column
(``dist.new_group``, made by every rank in the same order), and the
device this rank computes on. The device is the caller's choice: several
ranks may share one card, which ``DeviceMesh`` does not plan for.

A sharded array is held as this rank's block, as inside a ``shard_map``
body. :meth:`RadioMesh.axis` gives this rank's
:class:`~radiocore_tpu_torch.parallel.collectives.Axis` for ``STATIONS``,
``TIME`` or the flat pair ``(STATIONS, TIME)`` (all ranks, in row-major
order, as ``P((STATIONS, TIME))`` in the reference).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from radiocore_tpu_torch.parallel.collectives import (Axis, CollectiveBytes,
                                                      all_gather)
from radiocore_tpu_torch.runtime.platform import default_device

STATIONS = "stations"
TIME = "time"
FLAT = (STATIONS, TIME)

AxisName = Union[str, Tuple[str, str]]


class RadioMesh:
    """A ``(stations, time)`` grid of the world's ranks, as this rank
    sees it (see :func:`make_radio_mesh`).

    ``shape`` maps axis names to sizes, ``ranks`` is the grid of global
    ranks, ``rank`` this process's, ``device`` the device it computes on
    and ``counter`` the bytes of every collective on the mesh's axes.
    """

    def __init__(self, stations: int, time: int,
                 device: torch.device) -> None:
        world = dist.is_initialized()
        self.rank = dist.get_rank() if world else 0
        self.ranks = np.arange(stations * time).reshape(stations, time)
        self.shape: Dict[str, int] = {STATIONS: stations, TIME: time}
        self.device = device
        self.counter = CollectiveBytes()
        s, t = map(int, np.argwhere(self.ranks == self.rank)[0])
        backend = dist.get_backend() if world else None
        lines = {STATIONS: [tuple(self.ranks[:, j]) for j in range(time)],
                 TIME: [tuple(self.ranks[i, :]) for i in range(stations)],
                 FLAT: [tuple(self.ranks.reshape(-1))]}
        mine = {STATIONS: (lines[STATIONS][t], s),
                TIME: (lines[TIME][s], t),
                FLAT: (lines[FLAT][0], self.rank)}
        self._axes: Dict[AxisName, Axis] = {}
        for name, (ranks, index) in mine.items():
            group = None
            if len(ranks) > 1:
                if len(ranks) == stations * time:
                    group = dist.group.WORLD
                else:
                    # Every rank makes every group of the axis, in order.
                    for line in lines[name]:
                        made = dist.new_group(list(map(int, line)))
                        if line == ranks:
                            group = made
            self._axes[name] = Axis(
                str(name), tuple(map(int, ranks)), index, group,
                backend if group is not None else None, self.counter)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis(self, name: AxisName) -> Axis:
        """This rank's view of ``STATIONS``, ``TIME`` or ``FLAT``."""
        try:
            return self._axes[tuple(name) if not isinstance(name, str)
                              else name]
        except KeyError:
            raise ValueError(f"no mesh axis {name!r}; {STATIONS!r}, "
                             f"{TIME!r} or {FLAT!r}") from None


def make_radio_mesh(stations: int = 0, time: int = 1, *,
                    device_type: Optional[str] = None) -> RadioMesh:
    """Build a ``(stations, time)`` mesh over the ranks of the
    ``torch.distributed`` world (one rank when none is initialized).

    ``stations=0`` sizes the station axis to use every rank given the
    time axis: station parallelism is the cheap axis (no collectives in
    steady state). ``device_type=None`` puts this rank on a card
    (``LOCAL_RANK``, else the global rank, modulo the cards present; it
    raises without one); ``"cpu"`` on the CPU.
    """
    n = dist.get_world_size() if dist.is_initialized() else 1
    if stations <= 0:
        if n % time != 0:
            raise ValueError(f"{n} ranks not divisible by time={time}")
        stations = n // time
    if stations * time != n:
        raise ValueError(f"mesh {stations}x{time} != {n} available ranks")
    if device_type == "cpu":
        device = torch.device("cpu")
    elif device_type in (None, "cuda"):
        default_device()                      # raises without a card
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    else:
        raise ValueError(f"device_type={device_type!r}: 'cuda' or 'cpu'")
    return RadioMesh(stations, time, device)


def block_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of block ``index`` when ``n`` items are dealt into
    ``parts`` contiguous blocks whose sizes differ by at most one."""
    return index * n // parts, (index + 1) * n // parts


def station_sharding(mesh: RadioMesh, n_stations: int) -> slice:
    """This rank's block of a station axis of ``n_stations``, dealt over
    every rank of the mesh in row-major order (``P((STATIONS, TIME))``,
    the layout of the reference's distributed front end) in contiguous
    blocks whose sizes differ by at most one."""
    axis = mesh.axis(FLAT)
    return slice(*block_bounds(int(n_stations), axis.size, axis.index))


def shard(x: torch.Tensor, mesh: RadioMesh,
          axis_name: AxisName = TIME) -> torch.Tensor:
    """This rank's block of the last axis of ``x``, split evenly over
    ``axis_name``."""
    axis = mesh.axis(axis_name)
    n = x.shape[-1]
    if n % axis.size:
        raise ValueError(f"length {n} does not split over {axis.size} ranks")
    b = n // axis.size
    return x[..., axis.index * b:(axis.index + 1) * b]


def unshard(block: torch.Tensor, mesh: RadioMesh,
            axis_name: AxisName = TIME) -> torch.Tensor:
    """The whole array, on every rank, from each rank's block of its last
    axis (the inverse of :func:`shard`; one all-gather)."""
    parts = all_gather(block, mesh.axis(axis_name))     # (D, ..., b)
    return torch.cat(list(parts.unbind(0)), dim=-1)

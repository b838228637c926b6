"""Start a ``torch.distributed`` world of local processes, and the port's
multi-rank dry run: the counterpart of ``__graft_entry__.dryrun_multichip``
in the reference.

:func:`run_world` spawns ``n_ranks`` fresh processes
(``torch.multiprocessing``, start method ``spawn``), joins them through
a file in a new temporary directory (no port to pick, no race between
worlds) and runs ``fn(rank, *args)`` in each; a rank that raises makes
it raise. ``fn`` must be importable by name (a module-level function).
Each rank takes the environment of the caller (``OMP_NUM_THREADS`` sets
its intra-op threads).
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from radiocore_tpu_torch.runtime.platform import initialize_multihost


def _rank_main(rank: int, n_ranks: int, init: str, backend: str,
               fn: Callable, args: tuple) -> None:
    initialize_multihost(init, n_ranks, rank, backend=backend)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, n_ranks: int, *args,
              backend: str = "gloo") -> None:
    """Run ``fn(rank, *args)`` in ``n_ranks`` new processes joined into
    one world over ``backend``. Returns when every rank has returned."""
    init_dir = Path(tempfile.mkdtemp(prefix="rc_world_"))
    try:
        mp.start_processes(
            _rank_main, nprocs=n_ranks, join=True, start_method="spawn",
            args=(n_ranks, f"file://{init_dir / 'init'}", backend, fn,
                  args))
    finally:
        shutil.rmtree(init_dir, ignore_errors=True)


def _dryrun_rank(rank: int, n_ranks: int, device_type: Optional[str]) -> None:
    from scipy import signal as sig

    from radiocore_tpu_torch.parallel.halo import zero_phase_fir_sharded
    from radiocore_tpu_torch.parallel.mesh import (FLAT, TIME,
                                                   make_radio_mesh, shard)
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step

    time_ax = 2 if n_ranks % 2 == 0 else 1
    mesh = make_radio_mesh(time=time_ax, device_type=device_type)
    # Two stations a rank, so that the distributed front end takes the
    # plan (C % D == 0).
    n_stations = 2 * n_ranks
    station_chunk = 50_000   # the smallest rate whose Nyquist clears 19 kHz
    audio_chunk = 10_000
    n_band = n_stations * station_chunk
    half = n_band // 2 - station_chunk // 2
    offsets = [int(-half + i * station_chunk) for i in range(n_stations)]
    step, state = make_multi_station_step(n_band, offsets, station_chunk,
                                          audio_chunk, mesh=mesh)
    planes = 0.1 * np.random.default_rng(1).standard_normal((2, n_band))
    band = torch.from_numpy((planes[0] + 1j * planes[1]).astype(
        np.complex64)).to(mesh.device)
    audio, state = step(shard(band, mesh, FLAT), state)
    if tuple(audio.shape) != (2, audio_chunk, 2):
        raise AssertionError(f"rank {rank}: audio {tuple(audio.shape)}")
    if time_ax > 1:
        taps = sig.firwin(33, 0.25)
        x = torch.ones(time_ax * 4096, dtype=torch.float32,
                       device=mesh.device)
        y = zero_phase_fir_sharded(shard(x, mesh, TIME), taps, mesh)
        if tuple(y.shape) != (4096,):
            raise AssertionError(f"rank {rank}: halo FIR {tuple(y.shape)}")
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def dryrun_multichip(n_ranks: int, device_type: Optional[str] = None
                     ) -> None:
    """Run one multi-station step over an ``n_ranks`` mesh (a ``time``
    axis of 2 where ``n_ranks`` is even, ``stations`` the rest; two
    stations of 50 000 S/s a rank, 10 000 audio samples) and, with a
    ``time`` axis, a halo zero-phase FIR, in a world of ``n_ranks`` local
    processes. ``device_type=None`` runs on the cards, over ``nccl`` when
    there is one card a rank and ``gloo`` otherwise; ``"cpu"`` over
    ``gloo``."""
    cards = torch.cuda.device_count() if device_type != "cpu" else 0
    backend = "nccl" if 0 < n_ranks <= cards else "gloo"
    run_world(_dryrun_rank, n_ranks, n_ranks, device_type, backend=backend)

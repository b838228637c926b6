"""Rank bodies of the port's CPU world tests (``test_torch_parallel.py``,
``test_torch_halo.py``).

Each test module spawns one 4-rank ``gloo`` world on the CPU through
``radiocore_tpu_torch.parallel.dryrun.run_world``; every rank runs one of
the functions below on the seeded NumPy inputs in ``<dir>/inputs.npz``
and writes what it computed to ``<dir>/rank<r>.npz`` (arrays) and
``<dir>/rank<r>.json`` (byte counts, shapes, summaries), which the tests
then hold against the JAX package. This module imports no JAX: the ranks
run the port alone.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

N_RANKS = 4


def _write(out_dir: Path, rank: int, arrays: dict, info: dict) -> None:
    np.savez(out_dir / f"rank{rank}.npz", **arrays)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(info))


def parallel_rank(rank: int, out_dir: str) -> None:
    """Mesh, distributed FFTs, extraction, the multi-station step."""
    from radiocore_tpu_torch.parallel import channelize_sharded as cs
    from radiocore_tpu_torch.parallel import fft_sharded as fs
    from radiocore_tpu_torch.parallel.collectives import all_gather
    from radiocore_tpu_torch.parallel.comm_analysis import collective_bytes
    from radiocore_tpu_torch.parallel.halo import (fir_overlap_save_halo,
                                                   zero_phase_fir_sharded)
    from radiocore_tpu_torch.parallel.mesh import (FLAT, TIME,
                                                   make_radio_mesh, shard,
                                                   unshard)
    from radiocore_tpu_torch.parallel.pipeline import (
        gather_stations, make_multi_station_step)
    from radiocore_tpu_torch.runtime.platform import platform_summary

    out_dir = Path(out_dir)
    inp = {k: v for k, v in np.load(out_dir / "inputs.npz").items()}
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    arrays, info = {}, {}

    info["summary"] = {k: platform_summary()[k]
                       for k in ("process_index", "process_count")}
    m22 = make_radio_mesh(time=2, device_type="cpu")
    m41 = make_radio_mesh(device_type="cpu")
    m14 = make_radio_mesh(stations=1, time=4, device_type="cpu")
    info["mesh_shapes"] = [m22.shape, m41.shape, m14.shape]
    info["axes"] = {str(name): list(m22.axis(name).ranks)
                    for name in ("stations", "time", FLAT)}
    for bad in ((3, 2), (0, 3)):
        try:
            make_radio_mesh(*bad, device_type="cpu")
            info[f"mesh_{bad}"] = "built"
        except ValueError as err:
            info[f"mesh_{bad}"] = str(err)

    # Distributed FFTs over a 4-rank time axis.
    tax = m14.axis(TIME)
    for n in (65_536, 200_000):
        x = t[f"fft{n}"]
        arrays[f"blocks{n}"] = unshard(
            fs.fft_sharded_blocks(shard(x, m14), m14), m14).numpy()
    x = t["fft65536"]
    arrays["auto"] = fs.fft_sharded_auto(shard(x, m14), m14).numpy()
    for n, n1 in ((65_536, 256), (320_000, 400)):
        z = fs.fft_sharded_fourstep(shard(t[f"fft{n}"], m14), m14, n1=n1)
        arrays[f"fourstep{n}"] = all_gather(z, tax).reshape(n1, -1).numpy()
    # _fourstep_local at 2^20 over a 2-rank axis (the time axis of m22).
    ax2 = m22.axis(TIME)
    blk = shard(t["tw"], m22).reshape(512, 1024)
    z = fs._fourstep_local(blk, 1024, 1024, ax2)
    arrays["fourstep_local"] = all_gather(z, ax2).reshape(1024, 1024).numpy()

    # The distributed front end over the flat axis of m22.
    shifts = tuple(int(s) for s in inp["ex_shifts"])
    body = cs.make_extract_body(200_000, shifts, 50_000, 4, m22.axis(FLAT))
    iq = body(shard(t["ex_band"], m22, FLAT))
    arrays["extract"] = gather_stations(iq, m22).numpy()

    # The config-4 form: halo overlap-save FIR, then the extraction body,
    # on one 4-rank axis; and the bytes each moves.
    n, m = 1 << 16, 16
    shifts4 = tuple(int(s) for s in inp["c4_shifts"])
    body4 = cs.make_extract_body(n, shifts4, n // m, 4, tax)
    blk = shard(t["c4_band"], m14)
    y, _ = fir_overlap_save_halo(blk, inp["fir33"], tax)
    arrays["config4"] = gather_stations(body4(y), m14).numpy()
    m14.counter.reset()
    body4(blk)
    info["bytes_extract"] = collective_bytes(m14.counter)
    m14.counter.reset()
    fir_overlap_save_halo(blk, inp["fir129"], tax)
    info["bytes_fir129"] = collective_bytes(m14.counter)

    # make_multi_station_step over m22: both branches, both modes, two
    # chained chunks each.
    sc, ac = 50_000, 10_000
    for plan in ("dist", "gather"):
        offs = [int(o) for o in inp[f"offs_{plan}"]]
        for mode in ("fast", "exact"):
            step, state = make_multi_station_step(4 * sc, offs, sc, ac,
                                                  mode=mode, mesh=m22)
            info[f"distributed_{plan}_{mode}"] = step.distributed
            audios = []
            for k in range(2):
                band = t[f"band_{plan}{k}"]
                audio, state = step(shard(band, m22, FLAT), state)
                audios.append(gather_stations(audio, m22))
            arrays[f"step_{plan}_{mode}"] = torch.stack(audios).numpy()
            if plan == "dist" and mode == "exact":
                info["checksum"] = float(audios[-1].abs().mean())

    # The zero-phase halo FIR over the 2-rank time axis of m22.
    xs = torch.sin(torch.arange(2 * 4096, dtype=torch.float32) * 0.01)
    y = zero_phase_fir_sharded(shard(xs, m22), inp["fir33_025"], m22)
    info["halo_checksum"] = float(unshard(y, m22).abs().mean())
    _write(out_dir, rank, arrays if rank == 0 else {}, info)


def halo_rank(rank: int, out_dir: str) -> None:
    """Halo exchange and the streaming sharded filters."""
    from radiocore_tpu_torch.ops.pfb import pfb_init
    from radiocore_tpu_torch.parallel.collectives import all_gather
    from radiocore_tpu_torch.parallel.halo import (
        fir_causal_sharded, fir_overlap_save_halo, halo_exchange,
        pfb_channelize_halo, zero_phase_fir_sharded)
    from radiocore_tpu_torch.parallel.mesh import (TIME, make_radio_mesh,
                                                   shard, unshard)

    out_dir = Path(out_dir)
    inp = {k: v for k, v in np.load(out_dir / "inputs.npz").items()}
    arrays, info = {}, {}
    mesh = make_radio_mesh(stations=1, time=N_RANKS, device_type="cpu")
    axis = mesh.axis(TIME)

    def t(name):
        return torch.from_numpy(inp[name])

    x = torch.arange(4 * 8, dtype=torch.float32).reshape(2, 16)
    arrays["halo"] = all_gather(halo_exchange(shard(x, mesh), 3, 2, axis),
                                axis).numpy()

    arrays["fir_causal"] = unshard(fir_causal_sharded(
        shard(t("fir_x"), mesh), inp["fir_taps"], mesh), mesh).numpy()
    arrays["zero_phase"] = unshard(zero_phase_fir_sharded(
        shard(t("zp_x"), mesh), inp["zp_taps"], mesh), mesh).numpy()

    hist = torch.zeros(128, dtype=torch.complex64)
    for k in range(2):
        y, hist = fir_overlap_save_halo(shard(t(f"ols{k}"), mesh),
                                        inp["ols_taps"], axis,
                                        stream_history=hist)
        arrays[f"ols_y{k}"] = unshard(y, mesh).numpy()
    arrays["ols_hist"] = hist.numpy()

    m, p = 16, 8
    hist = pfb_init(m, p, device="cpu")
    for k in range(2):
        ch, hist = pfb_channelize_halo(shard(t(f"pfb{k}"), mesh),
                                       inp["pfb_taps"], m, axis,
                                       stream_history=hist)
        arrays[f"pfb_ch{k}"] = all_gather(ch, axis).reshape(-1, m).numpy()
    arrays["pfb_hist"] = hist.numpy()
    ch1, hist1 = pfb_channelize_halo(shard(t("pfb0"), mesh),
                                     inp["pfb_taps_p1"], m, axis)
    arrays["pfb_p1"] = all_gather(ch1, axis).reshape(-1, m).numpy()
    info["pfb_p1_hist_shape"] = list(hist1.shape)
    _write(out_dir, rank, arrays if rank == 0 else {}, info)


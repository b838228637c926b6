"""The bands of a configuration with several SDRs side by side (``bands``
in the configuration): each band's station offsets from its own centre,
and a pool of band chunks a band.

Each band carries ``stations_a_band`` stations on the configuration's
channel grid, laid out as ``signals.offsets`` lays out one band's and
then moved by the band's ``band_shift_hz`` (a whole number of Hz), so
that two bands can hold different plans. Its pool is
``signals.band_pool``'s, from a seed of its own, moved by the same
shift: a whole number of cycles in each one-second chunk, so the pool
stays phase-continuous, the last chunk to the first included. Bands
made from different seeds carry different tones and noise, so rows
swapped between bands do not match the reference.
"""

from __future__ import annotations

import math
from typing import List

import torch

from portbench import signals

# Band b's pool is made from seed + b * SEED_STRIDE: a stride that moves
# the low 32 bits too, which are all of the seed a CPU generator keeps.
SEED_STRIDE = 0x9E3779B9


def one_band(config: dict) -> dict:
    """The configuration of one band: ``stations_a_band`` stations."""
    return dict(config, stations=int(config["stations_a_band"]))


def band_offsets(config: dict) -> List[List[int]]:
    """Each band's station offsets from its centre in Hz. Raises where a
    band's count disagrees with ``bands`` and ``stations``, or a station
    leaves its band."""
    b = int(config["bands"])
    shifts = [int(s) for s in config["band_shift_hz"]]
    per = one_band(config)
    if len(shifts) != b or b * per["stations"] != int(config["stations"]):
        raise ValueError(f"{b} bands of {per['stations']} stations with "
                         f"{len(shifts)} shifts are not "
                         f"{config['stations']} stations")
    base = signals.offsets(per)
    half = int(config["band_rate"]) // 2 - int(config["station_rate"]) // 2
    out = [[o + s for o in base] for s in shifts]
    for k, offs in enumerate(out):
        if max(abs(o) for o in offs) > half:
            raise ValueError(f"band {k}: a station leaves the band")
    return out


def band_pools(seed: int, config: dict, traffic: dict,
               device: torch.device | str) -> torch.Tensor:
    """``(chunks, bands, band_rate)`` complex64: chunk p of every band,
    each band's pool as ``signals.band_pool`` makes it from its own seed,
    moved by the band's shift. The same seed gives the same pools."""
    per = one_band(config)
    band_offsets(config)
    n = int(config["band_rate"])
    chunks = int(traffic["pool_chunks"])
    shifts = [int(s) for s in config["band_shift_hz"]]
    out = torch.empty((chunks, len(shifts), n), dtype=torch.complex64,
                      device=device)
    t = torch.arange(n, dtype=torch.float64, device=device) / n
    for b, shift in enumerate(shifts):
        pool = signals.band_pool(int(seed) + b * SEED_STRIDE, per, traffic,
                                 device)
        if shift:
            turn = torch.polar(torch.ones_like(t), (2 * math.pi * shift) * t)
            for p in range(chunks):
                out[p, b] = (pool[p].to(torch.complex128) * turn).to(
                    torch.complex64)
            del turn
        else:
            out[:, b] = pool
        del pool
    return out

"""The band of the ``resident_pll`` mix: :func:`portbench.signals.band_pool`
with each station's own pilot, as real transmitters have them.

A station's 19 kHz pilot may lie 2 Hz either side of 19 kHz (47 CFR
73.322) and starts at any phase. Each station's pilot here is
``19 kHz + k / chunks`` Hz, ``k`` a whole number drawn from the seed
within ``pilot_offset_hz``, at a phase drawn uniformly from
``pilot_phase``; its 38 kHz subcarrier is coherent with it, at twice its
frequency and phase, as a stereo encoder derives it. Every frequency of
the multiplex stays on the ``1 / chunks``-Hz grid, so the pool still
holds whole periods of every component and joins phase-continuously at
the wrap, as ``signals`` explains.

The draws, in order from one generator: the tones (as ``signals``), the
pilot offsets, the pilot phases, the noise.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from portbench import signals

PILOT_HZ = 19e3


def draws(seed: int, config: dict, traffic: dict,
          device: torch.device | str
          ) -> Tuple[torch.Generator, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """The generator of ``seed`` after the draws, and the draws: each
    station's tones ``(c, 2)`` in Hz (as ``signals``) and its pilot's
    frequency in Hz and phase in radians ``(c,)``, float64 on
    ``device``."""
    c = int(config["stations"])
    chunks = int(traffic["pool_chunks"])
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    lo, hi = (int(round(f * chunks)) for f in traffic["tone_hz"])
    tones = torch.randint(lo, hi + 1, (c, 2), generator=gen,
                          device=device).to(torch.float64) / chunks
    lo, hi = (int(round(f * chunks)) for f in traffic["pilot_offset_hz"])
    k = torch.randint(lo, hi + 1, (c,), generator=gen, device=device)
    freq = PILOT_HZ + k.to(torch.float64) / chunks
    p0, p1 = (float(p) for p in traffic["pilot_phase"])
    phase = p0 + (p1 - p0) * torch.rand(c, generator=gen, device=device,
                                        dtype=torch.float64)
    return gen, tones, freq, phase


def band_pool(seed: int, config: dict, traffic: dict,
              device: torch.device | str) -> torch.Tensor:
    """``(chunks, band_rate)`` complex64 band chunks from ``seed``:
    ``signals.band_pool``'s band with the pilots of :func:`draws`.
    ``traffic`` also gives ``pilot_offset_hz`` ``[lo, hi]`` and
    ``pilot_phase`` ``[lo, hi)`` in radians."""
    c = int(config["stations"])
    sc = int(config["station_rate"])
    n = int(config["band_rate"])
    chunks = int(traffic["pool_chunks"])
    device = torch.device(device)
    gen, tones, pilot_f, pilot_ph = draws(seed, config, traffic, device)
    f64 = dict(dtype=torch.float64, device=device)
    total = chunks * sc
    t = torch.arange(total, **f64) / sc
    audio = float(traffic["audio_amp"])
    pilot_amp = float(traffic["pilot_amp"])
    sub_gain = 1.0 / (0.54 + 0.46 * math.cos(2 * math.pi * 38e3 / sc))
    k = torch.fft.fftfreq(total, 1.0 / total, device=device).long()
    spec = torch.zeros(chunks * n, dtype=torch.complex128, device=device)
    offs = torch.tensor(signals.offsets(config), device=device)
    gain = float(traffic["deviation_gain"])
    for b in range(0, c, signals.BLOCK):
        tb = tones[b:b + signals.BLOCK]
        theta = (2 * math.pi * pilot_f[b:b + signals.BLOCK, None] * t
                 + pilot_ph[b:b + signals.BLOCK, None])
        left = audio * torch.sin(2 * math.pi * tb[:, :1] * t)
        right = audio * torch.sin(2 * math.pi * tb[:, 1:] * t)
        mpx = ((left + right) / 2 + pilot_amp * torch.sin(theta)
               - torch.sin(2 * theta) * (left - right) * sub_gain)
        del left, right, theta
        phase = (math.pi * gain) * torch.cumsum(mpx, dim=-1)
        del mpx
        iq_spec = torch.fft.fft(torch.polar(torch.ones_like(phase), phase),
                                dim=-1) * (n / sc)
        del phase
        bins = (chunks * offs[b:b + signals.BLOCK, None] + k) % (chunks * n)
        spec[bins.reshape(-1)] = iq_spec.reshape(-1)
        del iq_spec, bins
    band = torch.fft.ifft(spec)
    del spec
    noise = float(traffic["noise_rms"])
    band += torch.complex(noise * torch.randn(chunks * n, generator=gen, **f64),
                          noise * torch.randn(chunks * n, generator=gen, **f64))
    return band.to(torch.complex64).reshape(chunks, n)

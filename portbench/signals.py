"""The band the benchmark feeds the port: seeded stereo FM stations, one
per slot, plus complex noise, built on the device in a few large calls.

Each station is the stereo multiplex of ITU-R BS.450 ((L+R)/2, a 19 kHz
pilot, (L-R) on a 38 kHz DSB subcarrier), each leg one tone, frequency
modulated onto complex baseband at the station rate. The tones lie on a
grid of ``1 / chunks`` Hz and the pilot and subcarrier are whole Hz, so
the multiplex and its phase repeat after ``chunks`` seconds: the pool of
chunks is phase-continuous from each chunk to the next, the last to the
first included, and cycling it never makes a click.

The stations are put into the band by their spectra, at the integer bin
of their offset (Hz == bin under the one-second convention), over the
whole pool at once, so no chunk boundary is a seam. They sit on the
configuration's channel grid, ``channel_spacing`` apart and centred on
the band, so that no two stations' ``station_rate`` bins overlap.
"""

from __future__ import annotations

import math
from typing import List

import torch

# Rows of stations made at a time: bounds the transient memory of set-up.
BLOCK = 16


def offsets(config: dict) -> List[int]:
    """Station offsets from the band centre in Hz: ``stations`` of them,
    ``channel_spacing`` apart, symmetric about the centre. Raises where
    two stations' bins would overlap or a station leaves the band."""
    c = int(config["stations"])
    spacing, sc = int(config["channel_spacing"]), int(config["station_rate"])
    n = int(config["band_rate"])
    if spacing < sc:
        raise ValueError(f"stations {spacing} Hz apart overlap at "
                         f"{sc} S/s each")
    doubled = [(2 * i - (c - 1)) * spacing for i in range(c)]
    if any(d % 2 for d in doubled):
        raise ValueError(f"{c} stations {spacing} Hz apart have no whole-Hz "
                         f"offsets about the centre")
    out = [d // 2 for d in doubled]
    if c and out[-1] + sc // 2 >= n // 2:
        raise ValueError(f"{c} stations {spacing} Hz apart do not fit a "
                         f"band of {n} S/s")
    return out


def band_pool(seed: int, config: dict, traffic: dict,
              device: torch.device | str) -> torch.Tensor:
    """``(chunks, band_rate)`` complex64 band chunks from ``seed``.

    ``config`` gives ``stations``, ``station_rate``, ``channel_spacing``
    and ``band_rate``;
    ``traffic`` gives ``pool_chunks`` and the signal's levels
    (``audio_amp``, ``pilot_amp``, ``deviation_gain``, ``noise_rms``) and
    the tone range ``tone_hz``. The same seed gives the same pool."""
    c = int(config["stations"])
    sc = int(config["station_rate"])
    n = int(config["band_rate"])
    chunks = int(traffic["pool_chunks"])
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    f64 = dict(dtype=torch.float64, device=device)
    lo, hi = (int(round(f * chunks)) for f in traffic["tone_hz"])
    # Tones on a 1/chunks-Hz grid: whole periods in the pool.
    tones = torch.randint(lo, hi + 1, (c, 2), generator=gen,
                          device=device).to(torch.float64) / chunks
    total = chunks * sc
    t = torch.arange(total, **f64) / sc
    audio = float(traffic["audio_amp"])
    sub_gain = 1.0 / (0.54 + 0.46 * math.cos(2 * math.pi * 38e3 / sc))
    pilot = float(traffic["pilot_amp"]) * torch.sin(2 * math.pi * 19e3 * t)
    sub = torch.sin(2 * math.pi * 38e3 * t)
    k = torch.fft.fftfreq(total, 1.0 / total, device=device).long()
    spec = torch.zeros(chunks * n, dtype=torch.complex128, device=device)
    offs = torch.tensor(offsets(config), device=device)
    gain = float(traffic["deviation_gain"])
    for b in range(0, c, BLOCK):
        tb = tones[b:b + BLOCK]
        left = audio * torch.sin(2 * math.pi * tb[:, :1] * t)
        right = audio * torch.sin(2 * math.pi * tb[:, 1:] * t)
        mpx = (left + right) / 2 + pilot - sub * (left - right) * sub_gain
        del left, right
        phase = (math.pi * gain) * torch.cumsum(mpx, dim=-1)
        del mpx
        iq_spec = torch.fft.fft(torch.polar(torch.ones_like(phase), phase),
                                dim=-1) * (n / sc)
        del phase
        bins = (chunks * offs[b:b + BLOCK, None] + k) % (chunks * n)
        spec[bins.reshape(-1)] = iq_spec.reshape(-1)
        del iq_spec, bins
    band = torch.fft.ifft(spec)
    del spec
    noise = float(traffic["noise_rms"])
    band += torch.complex(noise * torch.randn(chunks * n, generator=gen, **f64),
                          noise * torch.randn(chunks * n, generator=gen, **f64))
    return band.to(torch.complex64).reshape(chunks, n)

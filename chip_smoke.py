#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``radiocore_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds the hand-written kernels from ``radiocore_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``;
2. runs K-FFT (rows, band, rfft, and the ``ifft_pow2`` and ``irfft_pow2``
   wrappers), K-EXTRACT and K-FIR (51 taps at the main path's shape, timed
   before and after the FFT kernels; 129 taps; a ragged length through a
   strided view) at the main path's shapes against their
   plain PyTorch versions on the card, and times both, beside each
   kernel's bound (the least time the card could take) and, where one
   PyTorch call computes the same function, that call's time; K-EXTRACT
   runs through its station-group schedule and is also timed against the
   same passes over the whole batch (``[kernel] ... groups``);
3. drives the main path — ``make_multi_station_step(mode="fast")`` for
   64 stations × 262 144 S/s (a 2^24-sample band, 49 152 audio samples
   per station per chunk), the plan of ``bench.py`` — over 5 chained
   chunks of FM stations synthesized on the card from a seeded
   generator, checks that every kernel launched, and compares chunk 1
   with the same port run on the CPU;
4. decodes one real FM stereo station (440 Hz left, 1 kHz right) placed
   in a 2^24 band and checks both tones' SNR;
5. runs K-MIXED (the 24M = 96 · 2^18 band FFT, with its column pass and
   its row passes also timed apart), K-EXTRACT on that band, K-XDEMOD and
   K-XDEMOD-SPEC against their plain versions at the 96-station shapes,
   each also for 90 stations (a count the group size does not divide)
   from a start bin that makes a run wrap at the band's end inside a
   group, and grouped against ungrouped; K-XDEMOD's and K-XDEMOD-SPEC's
   passes are also timed apart (``[kernel] ... split``);
6. holds the kernels' discriminator (``atan2_fast``) against float64
   ``atan2`` on 2^24 seeded points (all magnitudes, the axes, signed
   zeros, subnormals), and feeds K-XDEMOD and K-XDEMOD-SPEC a band in
   which two stations' bins are exactly zero: a dead station's quad and
   kept bins must be exactly 0, the live stations within their bounds;
7. drives ``make_multi_station_step(extract_demod="spec")`` for 96
   stations × 262 144 S/s (band 24M) over 5 chained chunks — launch
   counters, step and stage times, chunk 1 against the CPU, one real
   stereo station — and the ``"fused"`` and default modes at 96
   stations over 2 chunks each (launch counters, chunk 1 against the
   CPU). The main and ``spec`` steps are also traced with
   ``torch.profiler`` (device time per kernel, busy and idle share);
8. runs K-NCO (the feedback pilot loop) against its plain PyTorch loop at
   8 x 4096 and on rows off a 16-byte boundary, and at 64 x 262 144, on
   rms-normalised 19 kHz pilots with a frequency offset and noise,
   against a float64 model of the loop for a few rows, modulo 2 pi; times
   it (CUDA events and ``torch.profiler``) beside its bytes bound and
   prints the cycles it takes per sample;
9. runs K-FIR at the pilot bandpass's shape (41 taps, 64 x 262 390, the
   odd extension included) against float64, and ``zero_phase_fir`` on the
   card against the port on the CPU;
10. drives ``make_multi_station_step(mode="exact")`` at 64 x 262 144 over
    3 chained chunks (launch counters: K-FFT, K-EXTRACT and three K-FIR
    launches a step; step and stage times; a profile; chunk 1 against the
    CPU; one real stereo station, and ``fast`` against ``exact`` on it);
11. drives ``make_wbfm_step(mode="exact", pll="nco")`` on a batch of 64
    stations over 2 chained chunks and ``WBFM(262 144, 49 152,
    pll="nco")`` over two chunks of one station through ``run`` (host
    array in, NumPy out): tones, the carried loop state, one K-NCO launch
    a chunk;
12. runs ``FM``, ``MFM``, ``WBFM``, ``Decimate``, ``Bandpass``,
    ``Deemphasis`` and ``PLL`` once each on the card at 262 144 against
    the port on the CPU, and a complex128 band, a float64 history and
    more than 4096 taps through ``ops/fft.fft`` and ``ops/fir.fir_causal``;
13. feeds whole steps (``off``, ``fused``, ``spec``) a 64-station spectrum
    in which two stations' bins are exactly zero: the dead stations'
    audio must be finite and, like the live ones', equal to the port's on
    the CPU;
14. drives the apps' path and the host edge under it: ``IngestPipe`` over
    pageable chunks of 2^24 and 96 · 2^18 complex64 at depths 1-3 (every
    chunk bit for bit, the host->pinned memcpy and the H2D copy apart,
    and from the ``torch.profiler`` timeline the share of the copies that
    the ``fast`` step overlaps at depth 2 against 1: ``[ingest]``);
    ``Tuner.load`` + ``run_all`` at the main plan against ``run(i)`` and
    complex128, with one band FFT's and one extraction's launches
    (``[tuner]``); ``multi_fm_server.serve_fused`` at 64 x 262 144 over 8
    chunks of a cf32 capture read through ``IQFileSource`` (stage means,
    chunks a second, real-time channels with host ingest, launches per
    chunk, audio equal to the same step on the bands already on the
    card, a real station's tones: ``[serve_fused]``); ``receive_fm.run``
    at the CLI's defaults for 5 s on the card and 2 s on the CPU from the
    same source seed (``[receive_fm]``); the native ring and IQ converter
    built from the port's own C++ (``[native]``); ``stereo_fm_iq`` against
    float64 (``[synth]``).

The build fails the run if ``ptxas`` reports register spills for the
demod pass of K-XDEMOD(-SPEC), for K-FIR's kernel or for K-NCO's.

Every phase raises on failure. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result. The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 1234

# The main plan (bench.py): 64 stations of 262 144 S/s, band 2^24.
N_STATIONS = 64
STATION = 262_144
AUDIO = 49_152
N_BAND = N_STATIONS * STATION
CHUNKS = 3
CHUNKS_EXACT = 3      # the exact path
CHUNKS_NCO = 2        # the nco paths

# The 96-station plan (bench.py's station count knob at 96): band
# 96 · 2^18 = 25 165 824, not a power of two, so the band FFT is K-MIXED.
N_STATIONS_96 = 96
N_BAND_96 = N_STATIONS_96 * STATION
C_ODD = 90            # a station count that no group of 4 or 8 divides
CHUNKS_MODES = 2      # the fused and default modes at 96 stations

REL_L2_MAX = 1e-5     # K-FFT, K-MIXED, K-EXTRACT against complex128
FIR_ABS_MAX = 1e-5    # K-FIR against float64
# The bounds of tests/test_extract_demod_pallas.py (:46, :148).
XDEMOD_ABS_MAX = 5e-5   # K-XDEMOD against float64
XSPEC_REL_MAX = 3e-5    # K-XDEMOD-SPEC, max abs / max |ref|
ATAN_ABS_MAX = 2e-6   # the discriminator against float64 atan2, rad
E2E_ABS_MAX = 1e-4    # card against CPU, audio of chunk 1
SNR_MIN_DB = 20.0     # per stereo tone, as the repository's verify drive
# K-NCO. Against its plain loop the kernel rounds alike (0 expected); the
# bound leaves room for a cosf that differs in its last bit. Against the
# float64 model the loop's own feedback holds float32 rounding down.
NCO_PLAIN_MAX = 1e-5  # rad, modulo 2 pi
NCO_F64_MAX = 2e-4    # rad, modulo 2 pi
NCO_SHORT = (8, 4096)
FAST_EXACT_MIN_DB = 40.0   # fast against exact audio on a real station

# Published peaks of one H100 SXM: the yardstick of each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNELS = {
    "K-FFT": ("radiocore_tpu_torch/csrc/fft_rows.cu",
              "radiocore_tpu/kernels/fft_pallas.py:258"),
    # K-FFT's wrappers off the main path, held at row shapes; their
    # launches are K-FFT's on the main path.
    "K-FFT ifft_pow2": ("radiocore_tpu_torch/csrc/fft_rows.cu",
                        "radiocore_tpu/kernels/fft_pallas.py:359"),
    "K-FFT irfft_pow2": ("radiocore_tpu_torch/csrc/fft_rows.cu",
                         "radiocore_tpu/kernels/fft_pallas.py:393"),
    "K-EXTRACT": ("radiocore_tpu_torch/csrc/extract.cu",
                  "radiocore_tpu/kernels/extract_pallas.py:108"),
    "K-FIR": ("radiocore_tpu_torch/csrc/fir.cu",
              "radiocore_tpu/kernels/fir_pallas.py:150"),
    "K-MIXED": ("radiocore_tpu_torch/csrc/fft_mixed.cu",
                "radiocore_tpu/kernels/fft_pallas.py:461"),
    "K-XDEMOD": ("radiocore_tpu_torch/csrc/extract_demod.cu",
                 "radiocore_tpu/kernels/extract_demod_pallas.py:153"),
    "K-XDEMOD-SPEC": ("radiocore_tpu_torch/csrc/extract_demod.cu",
                      "radiocore_tpu/kernels/extract_demod_pallas.py:278"),
    # Replaces a lax.scan, not a TPU kernel.
    "K-NCO": ("radiocore_tpu_torch/csrc/nco_pll.cu",
              "radiocore_tpu/ops/nco_pll.py:53"),
}


def offsets(c: int, sc: int):
    half = c * sc // 2 - sc // 2
    return [int(-half + i * sc) for i in range(c)]


def rel_l2(got, want) -> float:
    import torch
    d = got.to(want.dtype) - want
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(want))


def max_abs(got, want) -> float:
    return float((got.to(want.dtype) - want).abs().max())


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def time_min_median_ms(fn, reps: int = 50):
    """Min and median of ``reps`` CUDA-event timings of ``fn()``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in pairs]
    return min(ms), statistics.median(ms)


def traced(fn, reps: int, lead_ms: float = 100.0):
    """``[(start, end, name)]`` (microseconds) of every device event of
    ``reps`` calls of ``fn()``, traced with ``torch.profiler``.

    The profiler can drop what the card ran in the first milliseconds of
    its window (seen: the first of ten launches, two of three 20-ms
    launches, thirty 0.06-ms launches), so the window opens with
    ``lead_ms`` of unmeasured calls, and the measured ones lie between
    two launches of a marker kernel (the port's ``atan2_fast`` on one
    element, which no path launches): only events between the markers
    count. If a marker is lost the lead-in is made four times as long,
    twice over, before this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from radiocore_tpu_torch.kernels import extract_demod
    one = torch.ones(1, device="cuda")
    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while (time.perf_counter() - t0) * 1e3 < lead_ms:
                fn()
                torch.cuda.synchronize()
            extract_demod.atan2_fast(one, one)
            for _ in range(reps):
                fn()
            extract_demod.atan2_fast(one, one)
            torch.cuda.synchronize()
        events = sorted(
            (ev.time_range.start, ev.time_range.end, ev.name)
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA)
        marks = [ev for ev in events if "atan2_fast_kernel" in ev[2]]
        if len(marks) == 2:
            inside = [ev for ev in events
                      if marks[0][1] <= ev[0] < marks[1][0]]
            if inside:
                return inside
        lead_ms *= 4
    raise AssertionError(f"torch.profiler lost the start of its window "
                         f"(lead-ins up to {lead_ms / 4:.0f} ms)")


def kernel_times_ms(fn, reps: int = 10):
    """Device time per call of each kernel that ``fn()`` launches, from
    ``torch.profiler``: ``[(kernel name, ms)]`` in the order of launch."""
    total, first = {}, {}
    for t0, t1, name in traced(fn, reps):
        total[name] = total.get(name, 0.0) + (t1 - t0)
        first.setdefault(name, t0)
    return [(name, total[name] / reps / 1e3)
            for name in sorted(total, key=first.get)]


def report_split(what, fn, passes) -> None:
    """Print the device time of each pass kernel of ``fn()`` (the passes
    over the whole batch on one lane, so that no two overlap), named by
    ``passes`` in the order of launch."""
    times = [(n, ms) for n, ms in kernel_times_ms(fn) if "pass_kernel" in n]
    if len(times) != len(passes):
        raise AssertionError(f"{what}: {len(times)} pass kernels in the "
                             f"trace, expected {passes}")
    print(f"[kernel] {what} split (whole batch, one lane): " + ", ".join(
        f"{name} {ms:.3f} ms" for name, (_, ms) in zip(passes, times)))


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: every input byte read once and
    every output byte written once at the HBM rate, or the float32
    operations at the peak rate outside the tensor cores, whichever is
    longer."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def fft_flops(n: int, rows: int = 1) -> float:
    return 5.0 * n * math.log2(n) * rows


def time_pair_ms(fn_a, fn_b):
    """Medians of 20 of two functions timed in turns (a, b, b, a), so
    that neither has the warmer card."""
    a1, b1, b2, a2 = (time_ms(f, reps=10) for f in (fn_a, fn_b, fn_b, fn_a))
    return (a1 + a2) / 2, (b1 + b2) / 2


def fm_stations(gen, c: int, sc: int, device):
    """IQ of ``c`` FM stereo stations, ``(c, sc)`` complex128 (random
    tones per station, the multiplex of
    ``tests/oracles.make_stereo_multiplex`` and the modulation of
    ``make_fm_iq``), built on ``device`` from the generator ``gen``."""
    import torch
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(sc, **f64) / sc
    tones = 200.0 + 1800.0 * torch.rand(c, 2, generator=gen, **f64)
    left = 0.3 * torch.sin(2 * math.pi * tones[:, :1] * t)
    right = 0.3 * torch.sin(2 * math.pi * tones[:, 1:] * t)
    sub_gain = 1.0 / (0.54 + 0.46 * math.cos(2 * math.pi * 38e3 / sc))
    mpx = ((left + right) / 2 + 0.1 * torch.sin(2 * math.pi * 19e3 * t)
           - torch.sin(2 * math.pi * 38e3 * t) * (left - right) * sub_gain)
    return torch.exp(1j * math.pi * 0.25 * torch.cumsum(mpx, dim=-1))


def fm_band(gen, c: int, sc: int, device, real_slot=None):
    """Band chunk of the ``c`` stations of :func:`fm_stations`, one per
    slot, plus complex noise; with ``real_slot``, that slot carries the
    real station (440 Hz left, 1 kHz right; NumPy oracles) instead."""
    import torch
    f64 = dict(dtype=torch.float64, device=device)
    n = c * sc
    iq = fm_stations(gen, c, sc, device)
    if real_slot is not None:
        from oracles import make_fm_iq, make_stereo_multiplex
        iq[real_slot] = torch.from_numpy(make_fm_iq(
            make_stereo_multiplex(sc, sc, 440.0, 1000.0), 0.25)).to(device)
    k = torch.fft.fftfreq(sc, 1.0 / sc, device=device).long()
    bins = (torch.tensor(offsets(c, sc), device=device)[:, None] + k) % n
    spec = torch.zeros(n, dtype=torch.complex128, device=device)
    spec[bins.reshape(-1)] = (torch.fft.fft(iq, dim=-1) * (n / sc)).reshape(-1)
    band = torch.fft.ifft(spec)
    band += 0.01 * torch.complex(torch.randn(n, generator=gen, **f64),
                                 torch.randn(n, generator=gen, **f64))
    return band.to(torch.complex64)


def station_band(station: int, c: int, sc: int, noise_gen, device):
    """One FM stereo station (440 Hz left, 1 kHz right; numpy oracles)
    at the bins of slot ``station`` of a ``c·sc`` band; the rest noise."""
    import numpy as np
    import torch
    from oracles import make_fm_iq, make_stereo_multiplex
    n = c * sc
    iq = make_fm_iq(make_stereo_multiplex(sc, sc, 440.0, 1000.0), 0.25)
    k = (np.fft.fftfreq(sc) * sc).astype(np.int64)
    spec = np.zeros(n, np.complex128)
    spec[(offsets(c, sc)[station] + k) % n] = np.fft.fft(iq) * (n / sc)
    band = torch.from_numpy(np.fft.ifft(spec)).to(device)
    f64 = dict(dtype=torch.float64, device=device)
    band += 0.05 * torch.complex(torch.randn(n, generator=noise_gen, **f64),
                                 torch.randn(n, generator=noise_gen, **f64))
    return band.to(torch.complex64)


def crandn(gen, device, *shape):
    import torch
    return torch.complex(torch.randn(shape, generator=gen, device=device),
                         torch.randn(shape, generator=gen, device=device))


def report(what, err, limit, ms, plain_ms, least=None, library_ms=None):
    """Print one kernel check; raise if ``err`` is above ``limit`` (a NaN
    error fails too). ``least`` is the kernel's :func:`bound`."""
    line = (f"[kernel] {what}: {err:.3e} (bound {limit:.0e}) "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    if least:
        line += (f", least {least['bound_ms']:.3f} ms by "
                 f"{least['bound_by']} ({least['bound_ms'] / ms:.0%})")
    if library_ms is not None:
        line += f", library {library_ms:.3f} ms"
    print(line)
    if not err <= limit:
        raise AssertionError(f"{what}: error {err} above {limit}")


def report_groups(what, device, c, m, buffers, kernel):
    """Time ``kernel(group, lanes)`` at the grouped schedule that the
    device's L2 gives (``extract.grouped_schedule``) against the same
    passes over the whole batch on one lane."""
    from radiocore_tpu_torch.kernels import extract
    g, lanes = extract.grouped_schedule(device, m, buffers, c)
    grouped, whole = time_pair_ms(lambda: kernel(g, lanes),
                                  lambda: kernel(c, 1))
    print(f"[kernel] {what} groups: G = {g} on {lanes} lanes {grouped:.3f} "
          f"ms, ungrouped (G = {c}) {whole:.3f} ms")


def check_kernels(device, gen) -> dict:
    """Phase 2: each kernel against its plain version at the main path's
    shapes; returns per-kernel max_abs_err/ms/plain_ms."""
    import functools
    import torch
    from radiocore_tpu_torch.kernels import extract, fft_rows, fir
    from radiocore_tpu_torch.ops.design import deemphasis_taps

    crandn_ = functools.partial(crandn, gen, device)
    out = {}
    # K-FIR at the de-emphasis shape before anything else has run: its
    # time has varied between runs with what ran before it.
    taps = deemphasis_taps(AUDIO)
    x, hist = fir_case(torch.device(device), torch.Generator(
        device=device).manual_seed(SEED + 2), 2 * N_STATIONS, AUDIO, taps)
    fir_alone = time_min_median_ms(lambda: fir.fir_causal_rows(x, taps, hist))
    del x, hist
    rows = crandn_(N_STATIONS, STATION)
    got = fft_rows.fft_pow2(rows)
    err = rel_l2(got, torch.fft.fft(rows.to(torch.complex128)))
    plain = time_ms(lambda: fft_rows.fft_pow2_plain(rows))
    report("K-FFT rows 64x2^18 fwd rel_l2", err, REL_L2_MAX,
           time_ms(lambda: fft_rows.fft_pow2(rows)), plain,
           bound(16 * rows.numel(), fft_flops(STATION, N_STATIONS)), plain)
    del rows, got

    band = crandn_(N_BAND)
    band64 = band.to(torch.complex128)
    for sign, ref in ((-1.0, torch.fft.fft(band64)),
                      (+1.0, torch.fft.ifft(band64, norm="forward"))):
        got = fft_rows.fft_large_pow2(band, sign)
        err = rel_l2(got, ref)
        ms = time_ms(lambda: fft_rows.fft_large_pow2(band, sign))
        plain = time_ms(lambda: fft_rows.fft_pow2_plain(band, sign))
        name = "fwd" if sign < 0 else "bwd"
        least = bound(16 * N_BAND, fft_flops(N_BAND))
        report(f"K-FFT band 2^24 {name} rel_l2", err, REL_L2_MAX, ms, plain,
               least, plain)
        if sign < 0:
            out["K-FFT"] = dict(max_abs_err=max_abs(got, ref), ms=ms,
                                plain_ms=plain, **least, library_ms=plain)
        del got, ref
    del band64

    real = torch.randn(N_STATIONS, STATION, generator=gen, device=device)
    got = fft_rows.rfft_pow2(real)
    err = rel_l2(got, torch.fft.rfft(real.double()))
    plain = time_ms(lambda: fft_rows.rfft_pow2_plain(real))
    report("K-FFT rfft 64x2^18 real rel_l2", err, REL_L2_MAX,
           time_ms(lambda: fft_rows.rfft_pow2(real)), plain,
           bound(4 * real.numel() + 8 * got.numel(),
                 fft_flops(STATION // 2, N_STATIONS)), plain)
    del got

    # The wrappers off the main path, at the same row shapes.
    rows = crandn_(N_STATIONS, STATION)
    ref = torch.fft.ifft(rows.to(torch.complex128))
    got = fft_rows.ifft_pow2(rows)
    err = rel_l2(got, ref)
    ms = time_ms(lambda: fft_rows.ifft_pow2(rows))
    plain = time_ms(lambda: torch.fft.ifft(rows))
    least = bound(16 * rows.numel(), fft_flops(STATION, N_STATIONS))
    report("K-FFT ifft_pow2 64x2^18 rel_l2", err, REL_L2_MAX, ms, plain,
           least, plain)
    out["K-FFT ifft_pow2"] = dict(max_abs_err=max_abs(got, ref), ms=ms,
                                  plain_ms=plain, **least, library_ms=plain)
    spec = torch.fft.rfft(real)
    ref = torch.fft.irfft(spec.to(torch.complex128), n=STATION)
    got = fft_rows.irfft_pow2(spec, STATION)
    if tuple(got.shape) != (N_STATIONS, STATION):
        raise AssertionError(f"irfft_pow2 shape {tuple(got.shape)}")
    err = rel_l2(got, ref)
    ms = time_ms(lambda: fft_rows.irfft_pow2(spec, STATION))
    plain = time_ms(lambda: torch.fft.irfft(spec, n=STATION))
    least = bound(8 * spec.numel() + 4 * got.numel(),
                  fft_flops(STATION // 2, N_STATIONS))
    report("K-FFT irfft_pow2 64x2^18 real out rel_l2", err, REL_L2_MAX, ms,
           plain, least, plain)
    out["K-FFT irfft_pow2"] = dict(max_abs_err=max_abs(got, ref), ms=ms,
                                   plain_ms=plain, **least, library_ms=plain)
    del rows, real, spec, got, ref

    c, m, n = N_STATIONS, STATION, N_BAND
    s_norm = 1.0 / n
    spec = band
    spec64 = spec.to(torch.complex128)
    for a0 in (n // 2, n // 2 + 12_345):
        got = extract.extract_rows(spec, a0, c, m, s_norm)
        ref = extract.extract_rows_plain(spec64, a0, c, m, s_norm)
        err = rel_l2(got, ref)
        ms = time_ms(lambda: extract.extract_rows(spec, a0, c, m, s_norm))
        plain = time_ms(
            lambda: extract.extract_rows_plain(spec, a0, c, m, s_norm))
        least = bound(16 * c * m, fft_flops(m, c))
        report(f"K-EXTRACT 64x2^18 a0={a0} rel_l2", err, REL_L2_MAX, ms,
               plain, least)
        if a0 == n // 2:
            out["K-EXTRACT"] = dict(max_abs_err=max_abs(got, ref), ms=ms,
                                    plain_ms=plain, **least, library_ms=None)
        del got, ref
    report_groups("K-EXTRACT 64x2^18", device, c, m, 1,
                  lambda g, lanes: extract.extract_rows_kernel(
                      spec, n // 2, c, m, s_norm, group=g, lanes=lanes))
    del spec, spec64, band

    out["K-FIR"] = check_fir(device, gen, fir_alone)
    return out


def fir_case(device, gen, rows, n, taps):
    import torch
    x = torch.randn(rows, n, generator=gen, device=device)
    hist = torch.randn(rows, len(taps) - 1, generator=gen, device=device)
    return x, hist


def fir_device_ms(fn) -> float:
    """K-FIR's device time per call of ``fn()`` from ``torch.profiler``:
    the kernel is shorter than the host takes to enqueue it, so CUDA
    events around single calls time the host."""
    (_, ms), = [(n, t) for n, t in kernel_times_ms(fn, reps=30)
                if "fir_kernel" in n]
    return ms


def check_fir(device, gen, alone=None) -> dict:
    """K-FIR against float64 at the de-emphasis shape (51 taps, both
    stereo legs of 64 stations), at 129 taps (the band FIR's count) and on
    a ragged length through a strided view; returns the de-emphasis
    shape's numbers. ``alone`` is that shape's (min, median) time taken
    before any other kernel ran."""
    import torch
    from scipy import signal
    from radiocore_tpu_torch.kernels import fir
    from radiocore_tpu_torch.ops.design import deemphasis_taps

    taps = deemphasis_taps(AUDIO)
    x, hist = fir_case(device, gen, 2 * N_STATIONS, AUDIO, taps)
    got = fir.fir_causal_rows(x, taps, hist)
    ref = fir.fir_causal_plain(x.double(), taps, hist.double())
    err = max_abs(got, ref)
    ms = fir_device_ms(lambda: fir.fir_causal_rows(x, taps, hist))
    plain = time_ms(lambda: fir.fir_causal_plain(x, taps, hist))
    # The library call: one conv1d over the rows with their history in
    # front (float32; TF32 is off, see main), held to the same bound.
    xp = torch.cat([hist, x], dim=-1)[:, None, :]
    weight = torch.tensor(taps[::-1].copy(), dtype=torch.float32,
                          device=device)[None, None, :]
    conv = torch.nn.functional.conv1d(xp, weight)[:, 0, :]
    if not max_abs(conv, ref) <= FIR_ABS_MAX:
        raise AssertionError("conv1d is no reference for K-FIR: "
                             f"{max_abs(conv, ref)}")
    library = time_ms(lambda: torch.nn.functional.conv1d(xp, weight))
    least = bound(4 * (x.numel() + hist.numel() + got.numel()),
                  2.0 * len(taps) * x.numel())
    report("K-FIR 51 taps 128x49152 max_abs", err, FIR_ABS_MAX, ms, plain,
           least, library)
    after = time_min_median_ms(lambda: fir.fir_causal_rows(x, taps, hist))
    line = (f"[kernel] K-FIR 51 taps 128x49152 between CUDA events around "
            f"one call (the host's enqueue bounds it), 50 runs after the FFT "
            f"kernels: min {after[0]:.3f} ms, median {after[1]:.3f} ms")
    if alone:
        line += (f"; before any other kernel: min {alone[0]:.3f} ms, median "
                 f"{alone[1]:.3f} ms")
    print(line)
    stats = dict(max_abs_err=err, ms=ms, plain_ms=plain, **least,
                 library_ms=library)
    del x, hist, got, ref, xp, conv

    # 129 taps (the band FIR of bench.py's config 4), the same rows and
    # one long row batch.
    taps = signal.firwin(129, 0.45)
    for rows, n in ((2 * N_STATIONS, AUDIO), (N_STATIONS // 2, STATION)):
        x, hist = fir_case(device, gen, rows, n, taps)
        got = fir.fir_causal_rows(x, taps, hist)
        ref = fir.fir_causal_plain(x.double(), taps, hist.double())
        report(f"K-FIR 129 taps {rows}x{n} max_abs", max_abs(got, ref),
               FIR_ABS_MAX,
               fir_device_ms(lambda: fir.fir_causal_rows(x, taps, hist)),
               time_ms(lambda: fir.fir_causal_plain(x, taps, hist), reps=5),
               bound(4 * (x.numel() + hist.numel() + got.numel()),
                     2.0 * len(taps) * x.numel()))
        del x, hist, got, ref

    # A length that is no multiple of the tile or of 4, rows that are one
    # leg of a (rows, 2, n) tensor (every other row off a 16-byte
    # boundary), with and without history, and a long tap set.
    n = 50_001
    both = torch.randn(40, 2, n, generator=gen, device=device)
    for taps, with_hist in ((deemphasis_taps(AUDIO), True),
                            (deemphasis_taps(AUDIO), False),
                            (signal.firwin(4096, 0.3), True)):
        # (4096 taps: in-order float32 sums of that length hold the bound
        # on samples of audio size, the view scaled by 1/4.)
        x = both[:, 0, :] if len(taps) < 4096 else (0.25 * both)[:, 0, :]
        hist = 0.25 * torch.randn(40, len(taps) - 1, generator=gen,
                                  device=device) if with_hist else None
        got = fir.fir_causal_rows(x, taps, hist)
        ref = fir.fir_causal_plain(
            x.double(), taps, hist.double() if with_hist else None)
        err = max_abs(got, ref)
        print(f"[kernel] K-FIR {len(taps)} taps 40x{n} strided view, "
              f"history {with_hist} max_abs: {err:.3e} (bound "
              f"{FIR_ABS_MAX:.0e})")
        if not err <= FIR_ABS_MAX:
            raise AssertionError(f"K-FIR on the strided ragged shape: {err}")
    return stats


def check_band_kernels(device, gen) -> dict:
    """Phase 5: K-MIXED, K-EXTRACT, K-XDEMOD and K-XDEMOD-SPEC at the
    96-station shapes (band 96 · 2^18) against their plain versions;
    returns per-kernel max_abs_err/ms/plain_ms."""
    import torch
    from radiocore_tpu_torch.kernels import extract, extract_demod, fft_mixed
    from radiocore_tpu_torch.models.wbfm import make_wbfm_step
    from radiocore_tpu_torch.ops.channelize import uniform_extraction_start

    c, m, n = N_STATIONS_96, STATION, N_BAND_96
    c128 = torch.complex128
    out = {}
    band = crandn(gen, device, n)
    band64 = band.to(c128)
    for sign, ref in ((-1.0, torch.fft.fft(band64)),
                      (+1.0, torch.fft.ifft(band64, norm="forward"))):
        got = fft_mixed.fft_large_mixed(band, sign)
        err = rel_l2(got, ref)
        ms = time_ms(lambda: fft_mixed.fft_large_mixed(band, sign))
        plain = time_ms(lambda: fft_mixed.fft_large_mixed_plain(band, sign))
        name = "fwd" if sign < 0 else "bwd"
        least = bound(16 * n, fft_flops(n))
        report(f"K-MIXED band 96*2^18 {name} rel_l2", err, REL_L2_MAX, ms,
               plain, least, plain)
        if sign < 0:
            out["K-MIXED"] = dict(max_abs_err=max_abs(got, ref), ms=ms,
                                  plain_ms=plain, **least, library_ms=plain)
        del got, ref
    del band64
    # The two launch groups of K-MIXED apart (CUDA events around each).
    a, b = fft_mixed.mixed_split(n)
    bufs = fft_mixed.mixed_buffers(torch.empty_like(band), a, b)
    col = time_ms(lambda: fft_mixed.launch_column(band, bufs["x"], -1.0, a, b))
    rows = time_ms(lambda: fft_mixed.launch_rows(bufs, -1.0, a, b))
    print(f"[kernel] K-MIXED split {a}x{b}: column pass {col:.3f} ms, "
          f"row passes {rows:.3f} ms")
    del bufs

    s_norm = 1.0 / n
    spec64 = band.to(c128)
    for a0 in (n // 2, n // 2 + 12_345):
        got = extract.extract_rows(band, a0, c, m, s_norm)
        err = rel_l2(got, extract.extract_rows_plain(spec64, a0, c, m,
                                                     s_norm))
        report(f"K-EXTRACT 96x2^18 from 96*2^18 a0={a0} rel_l2", err,
               REL_L2_MAX,
               time_ms(lambda: extract.extract_rows(band, a0, c, m, s_norm)),
               time_ms(lambda: extract.extract_rows_plain(band, a0, c, m,
                                                          s_norm)),
               bound(16 * c * m, fft_flops(m, c)))
        del got
    # 90 stations (no group size divides into it evenly at 4 or 8), from a
    # start that makes station 37's run wrap at the band's end.
    a0 = (n // 2 + 10 * m + 12_345) % n
    g, lanes = extract.grouped_schedule(device, m, 1, C_ODD)
    got = extract.extract_rows_kernel(band, a0, C_ODD, m, s_norm, group=g,
                                      lanes=lanes)
    err = rel_l2(got, extract.extract_rows_plain(spec64, a0, C_ODD, m,
                                                 s_norm))
    print(f"[kernel] K-EXTRACT {C_ODD}x2^18 from 96*2^18 a0={a0} G = {g} on "
          f"{lanes} lanes rel_l2: {err:.3e} (bound {REL_L2_MAX:.0e})")
    if not err <= REL_L2_MAX:
        raise AssertionError(f"K-EXTRACT at c={C_ODD}: error {err}")
    del got
    report_groups("K-EXTRACT 96x2^18", device, c, m, 1,
                  lambda g, lanes: extract.extract_rows_kernel(
                      band, n // 2, c, m, s_norm, group=g, lanes=lanes))
    del spec64, band

    # An FM band (not noise: see PERF.md on the demod of a noise band).
    spec = torch.fft.fft(fm_band(gen, c, m, device))
    spec64 = spec.to(c128)
    shifts = tuple(-o for o in offsets(c, m))
    a0 = uniform_extraction_start(n, shifts, m)
    got = extract_demod.extract_demod_rows(spec, a0, c, m)
    ref = extract_demod.extract_demod_rows_plain(spec64, a0, c, m)
    if not bool((got[:, 0] == 0).all()):
        raise AssertionError("K-XDEMOD: quad[:, 0] is not exactly 0")
    err = max_abs(got, ref)
    ms = time_ms(lambda: extract_demod.extract_demod_rows(spec, a0, c, m))
    plain = time_ms(
        lambda: extract_demod.extract_demod_rows_plain(spec, a0, c, m))
    least = bound(12 * c * m, fft_flops(m, c))
    report(f"K-XDEMOD 96x2^18 from 96*2^18 a0={a0} max_abs", err,
           XDEMOD_ABS_MAX, ms, plain, least)
    out["K-XDEMOD"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, **least,
                           library_ms=None)
    del got, ref

    keep = int(make_wbfm_step(m, AUDIO, mode="fast_spec").needed_bins)
    got = extract_demod.extract_demod_spec_rows(spec, a0, c, m,
                                                keep_bins=keep)
    ref = extract_demod.extract_demod_spec_rows_plain(spec64, a0, c, m,
                                                      keep_bins=keep)
    if tuple(got.shape) != (c, keep):
        raise AssertionError(f"K-XDEMOD-SPEC shape {tuple(got.shape)}")
    err = max_abs(got, ref) / float(ref.abs().max())
    ms = time_ms(lambda: extract_demod.extract_demod_spec_rows(
        spec, a0, c, m, keep_bins=keep))
    plain = time_ms(lambda: extract_demod.extract_demod_spec_rows_plain(
        spec, a0, c, m, keep_bins=keep))
    least = bound(8 * c * (m + keep), 2 * fft_flops(m, c))
    report(f"K-XDEMOD-SPEC 96x2^18 keep {keep} max_abs/max|ref|", err,
           XSPEC_REL_MAX, ms, plain, least)
    out["K-XDEMOD-SPEC"] = dict(max_abs_err=max_abs(got, ref), ms=ms,
                                plain_ms=plain, **least, library_ms=None)
    del got, ref

    # The same stations through a band rolled by d bins, read from a0 + d:
    # 90 of them from station 10 on, so that a run wraps at the band's end
    # inside a group and the last group is short.
    d = 10 * m + 12_345
    rolled = torch.roll(spec, d)
    rolled64 = torch.roll(spec64, d)
    a0_r = (a0 + d) % n
    gain = 1.0 / math.pi
    g, lanes = extract.grouped_schedule(device, m, 1, C_ODD)
    got = extract_demod.extract_demod_kernel(rolled, a0_r, C_ODD, m, gain,
                                             None, group=g, lanes=lanes)
    err = max_abs(got, extract_demod.extract_demod_rows_plain(
        rolled64, a0_r, C_ODD, m))
    print(f"[kernel] K-XDEMOD {C_ODD}x2^18 a0={a0_r} G = {g} on {lanes} "
          f"lanes max_abs: {err:.3e} (bound {XDEMOD_ABS_MAX:.0e})")
    if not err <= XDEMOD_ABS_MAX:
        raise AssertionError(f"K-XDEMOD at c={C_ODD}: error {err}")
    g, lanes = extract.grouped_schedule(device, m, 2, C_ODD)
    got = extract_demod.extract_demod_kernel(rolled, a0_r, C_ODD, m, gain,
                                             keep, group=g, lanes=lanes)
    ref = extract_demod.extract_demod_spec_rows_plain(rolled64, a0_r, C_ODD,
                                                      m, keep_bins=keep)
    err = max_abs(got, ref) / float(ref.abs().max())
    print(f"[kernel] K-XDEMOD-SPEC {C_ODD}x2^18 a0={a0_r} keep {keep} G = {g} "
          f"on {lanes} lanes max_abs/max|ref|: {err:.3e} (bound "
          f"{XSPEC_REL_MAX:.0e})")
    if not err <= XSPEC_REL_MAX:
        raise AssertionError(f"K-XDEMOD-SPEC at c={C_ODD}: error {err}")
    del got, ref, rolled, rolled64, spec64

    report_groups("K-XDEMOD 96x2^18", device, c, m, 1,
                  lambda g, lanes: extract_demod.extract_demod_kernel(
                      spec, a0, c, m, gain, None, group=g, lanes=lanes))
    report_groups("K-XDEMOD-SPEC 96x2^18", device, c, m, 2,
                  lambda g, lanes: extract_demod.extract_demod_kernel(
                      spec, a0, c, m, gain, keep, group=g, lanes=lanes))
    report_split("K-XDEMOD 96x2^18",
                 lambda: extract_demod.extract_demod_kernel(
                     spec, a0, c, m, gain, None, group=c, lanes=1),
                 ("first pass", "demod pass"))
    report_split("K-XDEMOD-SPEC 96x2^18",
                 lambda: extract_demod.extract_demod_kernel(
                     spec, a0, c, m, gain, keep, group=c, lanes=1),
                 ("first pass", "demod pass", "keep pass"))
    return out


def check_discriminator(device, gen) -> None:
    """The kernels' discriminator against float64 ``atan2`` on 2^24
    points: magnitudes from 1e-30 to 1e30 at any angle, component ratios
    up to 1e8 either way, subnormals, the axes and the origin with either
    sign of zero. Its conventions: 0 at the origin, a zero ``y`` counts
    as +0."""
    import torch
    from radiocore_tpu_torch.kernels import extract_demod
    n = 1 << 22
    f64 = dict(dtype=torch.float64, device=device)

    def rand(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, **f64)

    mag, th = 10.0 ** rand(-30.0, 30.0), rand(-math.pi, math.pi)
    x1, y1 = mag * torch.cos(th), mag * torch.sin(th)
    x2 = torch.randn(n, generator=gen, **f64)
    y2 = x2 * 10.0 ** rand(-8.0, 8.0)
    # Subnormal float32 magnitudes (below 1.18e-38) and their neighbours.
    sub, th = 10.0 ** rand(-45.0, -37.0), rand(-math.pi, math.pi)
    x3, y3 = sub * torch.cos(th), sub * torch.sin(th)
    # The axes and the origin: a quarter of these points have x = +-0, a
    # quarter y = +-0, a sixteenth both.
    x4 = torch.randn(n, generator=gen, **f64) * 10.0 ** rand(-20.0, 20.0)
    y4 = torch.randn(n, generator=gen, **f64) * 10.0 ** rand(-20.0, 20.0)
    which = torch.randint(0, 16, (n,), generator=gen, device=device)
    x4 = torch.where(which % 4 == 0, torch.copysign(torch.zeros_like(x4), x4),
                     x4)
    y4 = torch.where(which // 4 == 0,
                     torch.copysign(torch.zeros_like(y4), y4), y4)
    x = torch.cat([x1, x2, x3, x4]).float()
    y = torch.cat([y1, y2, y3, y4]).float()
    got = extract_demod.atan2_fast(y, x)
    # float64 atan2 of the float32 inputs, a zero y taken as +0 (the
    # origin then gives 0 for x = +0 and pi for x = -0: set it to 0).
    y64 = torch.where(y == 0, torch.zeros_like(y), y).double()
    ref = torch.atan2(y64, x.double())
    origin = (x == 0) & (y == 0)
    ref = torch.where(origin, torch.zeros_like(ref), ref)
    err = max_abs(got, ref)
    at_origin = got[origin]
    print(f"[kernel] discriminator atan2_fast on {x.numel()} points "
          f"({int(origin.sum())} at the origin, "
          f"{int(((x == 0) ^ (y == 0)).sum())} on an axis) against float64 "
          f"atan2 max_abs: {err:.3e} rad (bound {ATAN_ABS_MAX:.0e})")
    if not err <= ATAN_ABS_MAX:
        raise AssertionError(f"atan2_fast: error {err} rad")
    if not bool((at_origin == 0).all()):
        raise AssertionError("atan2_fast: not exactly 0 at the origin")


def check_dead_stations(device, gen) -> None:
    """K-XDEMOD and K-XDEMOD-SPEC on a 96-station FM band in which the
    bins of two stations (one in the middle, the last) are exactly zero:
    a dead station's quad and kept bins must be exactly 0, as the plain
    versions and the JAX package give them, and the live stations stay
    within their bounds."""
    import torch
    from radiocore_tpu_torch.kernels import extract_demod
    from radiocore_tpu_torch.models.wbfm import make_wbfm_step
    from radiocore_tpu_torch.ops.channelize import uniform_extraction_start

    c, m, n = N_STATIONS_96, STATION, N_BAND_96
    dead = [c // 2, c - 1]
    live = [i for i in range(c) if i not in dead]
    spec = torch.fft.fft(fm_band(gen, c, m, device))
    a0 = uniform_extraction_start(n, tuple(-o for o in offsets(c, m)), m)
    for i in dead:
        # The station's run and the bin after it, which its Nyquist fold
        # reads.
        bins = (a0 + i * m + torch.arange(m + 1, device=device)) % n
        spec[bins] = 0
    spec64 = spec.to(torch.complex128)
    keep = int(make_wbfm_step(m, AUDIO, mode="fast_spec").needed_bins)
    failures = []

    got = extract_demod.extract_demod_rows(spec, a0, c, m)
    ref = extract_demod.extract_demod_rows_plain(spec64, a0, c, m)
    if bool((ref[dead] != 0).any()):
        raise AssertionError("the plain quad of a dead station is not 0")
    err = max_abs(got[live], ref[live])
    lo, hi = float(got[dead].min()), float(got[dead].max())
    print(f"[dead] K-XDEMOD 96x2^18, stations {dead} zeroed: their quad in "
          f"[{lo:g}, {hi:g}] (plain: 0), live stations max_abs {err:.3e} "
          f"(bound {XDEMOD_ABS_MAX:.0e})")
    if lo != 0 or hi != 0:
        failures.append(f"K-XDEMOD: a dead station's quad in [{lo}, {hi}]")
    if not err <= XDEMOD_ABS_MAX:
        failures.append(f"K-XDEMOD: live stations off by {err}")

    got = extract_demod.extract_demod_spec_rows(spec, a0, c, m,
                                                keep_bins=keep)
    ref = extract_demod.extract_demod_spec_rows_plain(spec64, a0, c, m,
                                                      keep_bins=keep)
    if bool((ref[dead] != 0).any()):
        raise AssertionError("the plain bins of a dead station are not 0")
    err = max_abs(got[live], ref[live]) / float(ref.abs().max())
    worst = float(got[dead].abs().max())
    print(f"[dead] K-XDEMOD-SPEC 96x2^18 keep {keep}, stations {dead} "
          f"zeroed: their bins max |.| {worst:g} (plain: 0; largest live "
          f"bin {float(ref.abs().max()):g}), live stations "
          f"max_abs/max|ref| {err:.3e} (bound {XSPEC_REL_MAX:.0e})")
    if worst != 0:
        failures.append(f"K-XDEMOD-SPEC: a dead station's bins up to {worst}")
    if not err <= XSPEC_REL_MAX:
        failures.append(f"K-XDEMOD-SPEC: live stations off by {err}")
    if failures:
        raise AssertionError("; ".join(failures))


def path_counters(c: int, extract_demod: str, mode: str = "fast") -> dict:
    """The launch counters of the kernels a path must go through."""
    from radiocore_tpu_torch.kernels import (extract, extract_demod as xd,
                                             fft_mixed, fft_rows, fir)
    band = {"K-FFT": fft_rows.launches} if c * STATION == N_BAND else {
        "K-MIXED": fft_mixed.launches}
    if mode == "exact":
        return {**band, "K-EXTRACT": extract.launches,
                "K-FIR": fir.launches}
    rfft = {"K-FFT": fft_rows.launches}
    middle = {"off": {"K-EXTRACT": extract.launches, **rfft},
              "fused": {"K-XDEMOD": xd.launches, **rfft},
              "spec": {"K-XDEMOD-SPEC": xd.spec_launches}}[extract_demod]
    return {**band, **middle, "K-FIR": fir.launches}


def run_main_path(device, gen, c=N_STATIONS, sc=STATION, ac=AUDIO,
                  chunks=CHUNKS, extract_demod="off", mode="fast"):
    """Drive a path over ``chunks`` chained chunks; returns the step, its
    state, the first chunk's band and audio and the launch counts of the
    kernels the path must go through (counted from 0 around the run)."""
    import torch
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step

    step, state = make_multi_station_step(c * sc, offsets(c, sc), sc, ac,
                                          mode=mode,
                                          extract_demod=extract_demod,
                                          device=device)
    bands = [fm_band(gen, c, sc, device) for _ in range(chunks)]
    counters = path_counters(c, extract_demod, mode)
    torch.cuda.synchronize()
    for counter in counters.values():
        counter.reset()
    audios = []
    for band in bands:
        audio, state = step(band, state)
        audios.append(audio)
    torch.cuda.synchronize()
    launches = {name: ctr.count for name, ctr in counters.items()}
    for audio in audios:
        if tuple(audio.shape) != (c, ac, 2):
            raise AssertionError(f"audio shape {tuple(audio.shape)}")
        if not bool(torch.isfinite(audio).all()):
            raise AssertionError("non-finite audio")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the mode="
                                 f"{mode!r}, extract_demod="
                                 f"{extract_demod!r} path")
    return step, state, bands[0], audios[0], launches


def step_ms(step, band, state, record=None) -> str:
    """Ten steps from ``state``: the min and median of their CUDA-event
    times, and the host's time to enqueue one (its clock around the ten,
    before the synchronize): the device waits for the host where that is
    the longer. The min goes into ``record["min_ms"]`` where given."""
    import torch
    times = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, state = step(band, state)
        end.record()
        times.append((start, end))
    host = (time.perf_counter() - t0) * 100.0
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in times]
    if record is not None:
        record["min_ms"] = min(ms)
    return (f"step {min(ms):.3f} ms (min of 10; median "
            f"{statistics.median(ms):.3f}; host enqueues one in {host:.3f})")


def stage_ms(step, band, state) -> dict:
    """Median of 20 per stage, each fed the previous stage's output."""
    (n1, f1), (n2, f2), (n3, f3) = step.stages.items()
    x1 = f1(band)
    x2 = f2(x1)
    return {n1: time_ms(lambda: f1(band)), n2: time_ms(lambda: f2(x1)),
            n3: time_ms(lambda: f3(x2, state))}


def profile_step(what, step, band, state, steps: int = 10) -> None:
    """Trace ``steps`` steps with ``torch.profiler`` and print, per step,
    the span from the first kernel's start to the last one's end, the
    device's busy time and idle share, and the device time of each kernel
    that takes at least 1% of the busy time."""
    def one_step():
        nonlocal state
        _, state = step(band, state)

    events = traced(one_step, steps)
    by_name, busy = {}, 0.0
    for t0, t1, name in events:
        busy += t1 - t0
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    span = max(t1 for _, t1, _ in events) - events[0][0]
    print(f"[{what}] profile, per step of {steps}: span "
          f"{span / steps / 1e3:.3f} ms, device busy "
          f"{busy / steps / 1e3:.3f} ms, idle share "
          f"{max(0.0, 1.0 - busy / span):.3f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if us < 0.01 * busy:
            break
        print(f"[{what}] profile   {us / steps / 1e3:.3f} ms  {name[:110]}")


def check_spills(log: str) -> None:
    """Print what ``ptxas -v`` reported as spilled for every pass kernel
    (``*_pass_kernel``) and raise if an instantiation of the demod pass,
    K-FIR's kernel or K-NCO's spills, or one does not appear in the log."""
    import re
    held = {"demod_pass_kernel": 0, "fir_kernel": 0, "nco_pll_kernel": 0}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if not (m and entry):
            continue
        spilled = int(m.group(1)) or int(m.group(2))
        name = next((k for k in held if k in entry), None)
        if name:
            held[name] += 1
            if spilled:
                raise AssertionError(f"{entry} spills registers: "
                                     f"{line.strip()}")
        elif spilled and "pass_kernel" in entry:
            print(f"[build] spills in {entry}: {line.strip()}")
        entry = None
    for name, seen in held.items():
        if not seen:
            raise AssertionError(f"no ptxas line for {name} in the build log")
        print(f"[build] {name}: {seen} instantiations, no register spills")


def against_cpu(what, c, band1, audio1, extract_demod="off",
                mode="fast") -> float:
    """Chunk 1 through the same port on the CPU; raise above the bound."""
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    step_cpu, state_cpu = make_multi_station_step(
        c * STATION, offsets(c, STATION), STATION, AUDIO, mode=mode,
        extract_demod=extract_demod, device="cpu")
    audio_cpu, _ = step_cpu(band1.cpu(), state_cpu)
    e2e = max_abs(audio1.cpu(), audio_cpu)
    print(f"[{what}] chunk 1 card vs CPU max_abs {e2e:.3e} "
          f"(bound {E2E_ABS_MAX:.0e})")
    if not e2e <= E2E_ABS_MAX:
        raise AssertionError(f"{what}: card and CPU audio differ by {e2e}")
    return e2e


def check_station(what, step, c, device, extract_demod="off", mode="fast"):
    """One real stereo station in slot c // 3 of a c-station band;
    returns its audio ``(AUDIO, 2)`` as float64 NumPy."""
    import numpy as np
    import torch
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    slot = c // 3
    noise_gen = torch.Generator(device=device).manual_seed(SEED + 1)
    band = station_band(slot, c, STATION, noise_gen, device)
    _, state0 = make_multi_station_step(
        c * STATION, offsets(c, STATION), STATION, AUDIO, mode=mode,
        extract_demod=extract_demod, device=device)
    audio, _ = step(band, state0)
    a = audio[slot].cpu().numpy().astype(np.float64)
    check_tones(what, f"slot {slot}", a)
    return a


def check_tones(what, where, audio, fs=AUDIO) -> None:
    """Both tones of the real station (440 Hz left, 1 kHz right) in its
    audio ``(fs, 2)``, the edges left out; raise below the bound."""
    from oracles import tone_snr_db
    a = audio[2000:-2000]
    snr = (tone_snr_db(a[:, 0], fs, 440.0),
           tone_snr_db(a[:, 1], fs, 1000.0))
    print(f"[{what}] {where}: left 440 Hz {snr[0]:.1f} dB, right 1 kHz "
          f"{snr[1]:.1f} dB (bound {SNR_MIN_DB:.0f} dB)")
    if not min(snr) > SNR_MIN_DB:
        raise AssertionError(f"{what} {where}: stereo tone SNR {snr} below "
                             f"{SNR_MIN_DB} dB")


def wrapped(a, b):
    """``a - b`` modulo 2 pi, in (-pi, pi]: two correct runs of the loop
    may wrap one sample apart."""
    import torch
    d = (a.double() - b.double() + math.pi) % (2 * math.pi) - math.pi
    return torch.where(d <= -math.pi, d + 2 * math.pi, d)


def pilots(gen, rows: int, n: int, device):
    """``rows`` rms-normalised 19 kHz pilots of ``n`` samples at
    ``STATION`` samples a second, float32: each with its own frequency
    offset (within +-3 Hz) and start phase, plus noise at 0.1 of the rms."""
    import torch
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(n, **f64) / STATION
    f = 19e3 + 6.0 * (torch.rand(rows, 1, generator=gen, **f64) - 0.5)
    phi = 2 * math.pi * torch.rand(rows, 1, generator=gen, **f64)
    x = math.sqrt(2.0) * torch.sin(2 * math.pi * f * t + phi)
    x += 0.1 * torch.randn(rows, n, generator=gen, **f64)
    return x.float()


def nco_model_f64(pilot, gains, phase, freq):
    """The loop in float64 NumPy, rows as the vector: ``(traj, phase,
    freq)``."""
    import numpy as np
    kp, ki, w0 = gains
    x = np.asarray(pilot, np.float64)
    phase = np.array(phase, np.float64)
    freq = np.array(freq, np.float64)
    traj = np.empty_like(x)
    for t in range(x.shape[-1]):
        err = x[:, t] * np.cos(phase)
        traj[:, t] = phase
        freq = freq + ki * err
        phase = phase + w0 + freq + kp * err
        phase = np.where(phase > np.pi, phase - 2 * np.pi, phase)
    return traj, phase, freq


def sm_clock_mhz():
    """The SM clock ``nvidia-smi`` reports right now, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def check_nco(device, gen) -> dict:
    """Phase 8: K-NCO against its plain loop at a short length (aligned
    rows and rows off a 16-byte boundary) and, at the nco path's shape,
    against a float64 model of the loop; its time beside its bound."""
    import numpy as np
    import torch
    from radiocore_tpu_torch.kernels import nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import pll_design

    gains = pll_design(STATION, 19e3, 50.0)
    rows, n = NCO_SHORT
    wide = pilots(gen, rows, n + 8, device)
    short = {}
    for what, x in ((f"{rows}x{n}", wide[:, :n].contiguous()),
                    (f"{rows}x{n + 1} rows off a 16-byte boundary",
                     wide[:, 1:n + 2])):
        phase0 = 2.0 * torch.rand(rows, generator=gen, device=device) - 1.0
        freq0 = 1e-5 * torch.randn(rows, generator=gen, device=device)
        got = knco.nco_pll_track_rows(x, *gains, phase0, freq0)
        ref = knco.nco_pll_track_plain(x, *gains, phase0, freq0)
        errs = (float(wrapped(got[0], ref[0]).abs().max()),
                float(wrapped(got[1], ref[1]).abs().max()),
                max_abs(got[2], ref[2]))
        ms = time_ms(lambda: knco.nco_pll_track_rows(x, *gains, phase0,
                                                     freq0), reps=5, warmup=1)
        print(f"[kernel] K-NCO {what} against the plain loop: trajectory "
              f"{errs[0]:.3e} rad, final phase {errs[1]:.3e} rad (bound "
              f"{NCO_PLAIN_MAX:.0e}, modulo 2 pi), final freq {errs[2]:.3e}; "
              f"kernel {ms:.3f} ms")
        if not (max(errs[:2]) <= NCO_PLAIN_MAX and errs[2] <= 1e-7):
            raise AssertionError(f"K-NCO {what} differs from its plain "
                                 f"loop: {errs}")
        if not short:
            short = dict(err=errs[0], ms=ms, plain_ms=time_ms(
                lambda: knco.nco_pll_track_plain(x, *gains, phase0, freq0),
                reps=2, warmup=0))
    del wide

    # The nco path's shape: 64 stations, one second.
    rows, n = N_STATIONS, STATION
    x = pilots(gen, rows, n, device)
    zeros = torch.zeros(rows, device=device)
    traj, phase, freq = knco.nco_pll_track_rows(x, *gains, zeros, zeros)
    torch.cuda.synchronize()
    held = [0, rows // 2, rows - 1]
    t0 = time.perf_counter()
    ref = nco_model_f64(x[held].cpu().numpy(), gains, np.zeros(len(held)),
                        np.zeros(len(held)))
    model_s = time.perf_counter() - t0
    err = float(wrapped(traj[held].cpu(), torch.from_numpy(ref[0])).abs().max())
    err_p = float(wrapped(phase[held].cpu(),
                          torch.from_numpy(ref[1])).abs().max())
    err_f = float((freq[held].cpu().double()
                   - torch.from_numpy(ref[2])).abs().max())
    # Locked: the integrator holds each row's frequency offset.
    hz = freq.double() * STATION / (2 * math.pi)
    ms = time_ms(lambda: knco.nco_pll_track_rows(x, *gains, zeros, zeros),
                 reps=5, warmup=1)
    # The SM clock while the kernel runs: some launches in flight.
    for _ in range(8):
        knco.nco_pll_track_rows(x, *gains, zeros, zeros)
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    (_, device_ms), = [(k, t) for k, t in kernel_times_ms(
        lambda: knco.nco_pll_track_rows(x, *gains, zeros, zeros), reps=3)
        if "nco_pll_kernel" in k]
    least = bound(4 * (2 * x.numel() + 4 * rows), 30.0 * x.numel())
    # As many samples over 32 times the rows: whether the time follows
    # the row length alone.
    many = x.reshape(32 * rows, n // 32)
    zeros_many = torch.zeros(32 * rows, device=device)
    many_ms = time_ms(lambda: knco.nco_pll_track_rows(
        many, *gains, zeros_many, zeros_many), reps=5, warmup=1)
    print(f"[kernel] K-NCO {rows}x{n} against the float64 model (rows "
          f"{held}, {model_s:.1f} s on the host): trajectory {err:.3e} rad, "
          f"final phase {err_p:.3e} rad (bound {NCO_F64_MAX:.0e}, modulo "
          f"2 pi), final freq {err_f:.3e}; tracked offsets "
          f"{float(hz.min()):+.2f} .. {float(hz.max()):+.2f} Hz")
    print(f"[kernel] K-NCO {rows}x{n}: kernel {ms:.3f} ms between CUDA "
          f"events, {device_ms:.3f} ms device time, least "
          f"{least['bound_ms']:.3f} ms by {least['bound_by']} "
          f"({least['bound_ms'] / ms:.1%}); {ms * 1e-3 * mhz * 1e6 / n:.1f} "
          f"cycles a sample at {mhz:.0f} MHz (nvidia-smi clocks.sm during "
          f"the run); at {NCO_SHORT[0]}x{NCO_SHORT[1]}: kernel "
          f"{short['ms']:.3f} ms, plain loop {short['plain_ms']:.1f} ms; "
          f"the same samples as {32 * rows}x{n // 32}: {many_ms:.3f} ms; no "
          f"library call")
    if not (max(err, err_p) <= NCO_F64_MAX and err_f <= 1e-6):
        raise AssertionError(f"K-NCO against float64: {err}, {err_p}, "
                             f"{err_f}")
    if not float(hz.abs().max()) < 4.0:
        raise AssertionError(f"K-NCO did not lock: offsets {hz}")
    return dict(max_abs_err=short["err"], ms=ms, plain_ms=short["plain_ms"],
                plain_shape=f"{NCO_SHORT[0]}x{NCO_SHORT[1]}", **least,
                library_ms=None)


def check_fir_pilot(device, gen) -> None:
    """Phase 9: K-FIR at the pilot bandpass's shape (41 taps over the
    odd-extended rows of 64 stations) against float64, and
    ``zero_phase_fir`` on the card against the port on the CPU."""
    import torch
    from radiocore_tpu_torch.kernels import fir
    from radiocore_tpu_torch.models.wbfm import (PILOT_HI, PILOT_LO,
                                                 PILOT_TAPS)
    from radiocore_tpu_torch.ops.design import bandpass_taps
    from radiocore_tpu_torch.ops.fir import fir_route, zero_phase_fir

    taps = bandpass_taps(PILOT_TAPS, PILOT_LO, PILOT_HI, STATION)
    rows, n = N_STATIONS, STATION + 2 * 3 * PILOT_TAPS
    x, hist = fir_case(device, gen, rows, n, taps)
    got = fir.fir_causal_rows(x, taps, hist)
    ref = fir.fir_causal_plain(x.double(), taps, hist.double())
    report(f"K-FIR {PILOT_TAPS} taps {rows}x{n} max_abs", max_abs(got, ref),
           FIR_ABS_MAX,
           fir_device_ms(lambda: fir.fir_causal_rows(x, taps, hist)),
           time_ms(lambda: fir.fir_causal_plain(x, taps, hist), reps=5),
           bound(4 * (x.numel() + hist.numel() + got.numel()),
                 2.0 * len(taps) * x.numel()))
    del got, ref, hist
    x = x[:, :STATION].contiguous()
    if fir_route(x, taps) != "kernel":
        raise AssertionError("zero_phase_fir's rows do not route to K-FIR")
    fir.launches.reset()
    got = zero_phase_fir(x, taps)
    count = fir.launches.count
    some = slice(None, None, 8)
    err = max_abs(got[some].cpu(), zero_phase_fir(x[some].cpu(), taps))
    ms = time_ms(lambda: zero_phase_fir(x, taps), reps=10)
    print(f"[kernel] zero_phase_fir {PILOT_TAPS} taps {rows}x{STATION}: "
          f"{count} K-FIR launches, card vs CPU (every 8th row) max_abs "
          f"{err:.3e} (bound {FIR_ABS_MAX:.0e}), {ms:.3f} ms with its "
          f"flips and copies")
    if count != 2 or not err <= FIR_ABS_MAX:
        raise AssertionError(f"zero_phase_fir on the card: {count} "
                             f"launches, error {err}")


def run_exact_path(device, gen, launches) -> None:
    """Phase 10: ``make_multi_station_step(mode="exact")`` at full width."""
    from oracles import snr_db
    c = N_STATIONS
    step, state, band1, audio1, counts = run_main_path(
        device, gen, chunks=CHUNKS_EXACT, mode="exact")
    print(f"[exact] {c} x {STATION} -> {AUDIO}, {CHUNKS_EXACT} chunks: "
          f"audio {tuple(audio1.shape)} finite; launches {counts}")
    if counts["K-FIR"] != 3 * CHUNKS_EXACT:
        raise AssertionError(f"exact: {counts['K-FIR']} K-FIR launches in "
                             f"{CHUNKS_EXACT} steps, expected 3 a step")
    for name, count in counts.items():
        launches.setdefault(name, count)
    band = fm_band(gen, c, STATION, device)
    print(f"[exact] {step_ms(step, band, state)}; stages (median of 20) "
          + ", ".join(f"{k} {v:.3f} ms"
                      for k, v in stage_ms(step, band, state).items()))
    profile_step("exact", step, band, state, steps=5)
    against_cpu("exact", c, band1, audio1, mode="exact")
    exact = check_station("exact station", step, c, device, mode="exact")
    del step, state, band1, audio1, band
    fast_step, _ = _fast_step(c, device)
    fast = check_station("exact station, fast mode", fast_step, c, device)
    db = [snr_db(exact[1000:-1000, ch], fast[1000:-1000, ch])
          for ch in range(2)]
    print(f"[exact] fast against exact on the station's audio: left "
          f"{db[0]:.1f} dB, right {db[1]:.1f} dB (bound "
          f"{FAST_EXACT_MIN_DB:.0f} dB)")
    if not min(db) > FAST_EXACT_MIN_DB:
        raise AssertionError(f"fast against exact: {db} dB")


def _fast_step(c, device, extract_demod="off"):
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    return make_multi_station_step(
        c * STATION, offsets(c, STATION), STATION, AUDIO, mode="fast",
        extract_demod=extract_demod, device=device)


def real_station_iq(seconds: int = 1):
    """The real station (440 Hz left, 1 kHz right; NumPy oracles) as
    complex64 IQ, ``seconds`` chunks of ``STATION`` samples."""
    import numpy as np
    from oracles import make_fm_iq, make_stereo_multiplex
    mpx = make_stereo_multiplex(seconds * STATION, STATION, 440.0, 1000.0)
    return make_fm_iq(mpx, 0.25).astype(np.complex64).reshape(seconds,
                                                              STATION)


def run_nco_paths(device, gen, launches) -> None:
    """Phase 11: the nco pilot tracker on a station batch through
    ``make_wbfm_step`` and on one station through the ``WBFM`` class."""
    import numpy as np
    import torch
    from radiocore_tpu_torch.kernels import fir, nco_pll as knco
    from radiocore_tpu_torch.models.wbfm import (WBFM, make_wbfm_step,
                                                 wbfm_init_state)

    c = N_STATIONS
    real = real_station_iq(CHUNKS_NCO)
    step = make_wbfm_step(STATION, AUDIO, mode="exact", pll="nco")
    state = wbfm_init_state(AUDIO, batch_shape=(c,), pll="nco",
                            device=device)
    chunks = []
    for i in range(CHUNKS_NCO):
        iq = fm_stations(gen, c, STATION, device).to(torch.complex64)
        iq[0] = torch.from_numpy(real[i]).to(device)
        chunks.append(iq)
    torch.cuda.synchronize()
    knco.launches.reset()
    fir.launches.reset()
    audios = []
    for iq in chunks:
        audio, state = step(iq, state)
        audios.append(audio)
    torch.cuda.synchronize()
    counts = {"K-NCO": knco.launches.count, "K-FIR": fir.launches.count}
    print(f"[nco] make_wbfm_step(pll='nco') {c} x {STATION} -> {AUDIO}, "
          f"{CHUNKS_NCO} chunks: launches {counts}")
    if counts != {"K-NCO": CHUNKS_NCO, "K-FIR": 3 * CHUNKS_NCO}:
        raise AssertionError(f"nco: launches {counts}")
    launches["K-NCO"] = counts["K-NCO"]
    for i, audio in enumerate(audios):
        if tuple(audio.shape) != (c, AUDIO, 2):
            raise AssertionError(f"nco: audio shape {tuple(audio.shape)}")
        if not bool(torch.isfinite(audio).all()):
            raise AssertionError("nco: non-finite audio")
        check_tones("nco", f"station batch, chunk {i + 1}, row 0",
                    audio[0].cpu().numpy().astype(np.float64))
    pll = state["pll"]
    hz = pll.freq.double() * STATION / (2 * math.pi)
    if tuple(pll.phase.shape) != (c,) or not bool((pll.phase != 0).all()):
        raise AssertionError("nco: the loop state was not carried")
    ms = time_ms(lambda: step(chunks[0], state), reps=3, warmup=1)
    print(f"[nco] step {ms:.3f} ms (median of 3); carried loop state: "
          f"frequency offsets {float(hz.min()):+.3f} .. "
          f"{float(hz.max()):+.3f} Hz")
    del chunks, audios, state

    wbfm = WBFM(STATION, AUDIO, pll="nco")
    knco.launches.reset()
    for i in range(CHUNKS_NCO):
        t0 = time.perf_counter()
        audio = wbfm.run(real[i])
        run_ms = (time.perf_counter() - t0) * 1e3
        if not isinstance(audio, np.ndarray) or audio.shape != (AUDIO, 2):
            raise AssertionError(f"WBFM.run gave {type(audio)}")
        check_tones("nco", f"WBFM(pll='nco').run chunk {i + 1} "
                    f"({run_ms:.1f} ms, host array in, NumPy out)",
                    audio.astype(np.float64))
    if knco.launches.count != CHUNKS_NCO:
        raise AssertionError(f"WBFM(pll='nco'): {knco.launches.count} K-NCO "
                             f"launches in {CHUNKS_NCO} chunks")


def check_classes(device, gen) -> None:
    """Phase 12: every model class once on the card at 262 144 against
    the port on the CPU, and the routes chosen by dtype and size."""
    import numpy as np
    import torch
    from radiocore_tpu_torch import models
    from radiocore_tpu_torch.kernels import fir
    from radiocore_tpu_torch.ops import fft as offt
    from radiocore_tpu_torch.ops.fir import fir_causal, fir_route

    iq = real_station_iq()[0]
    rng = np.random.default_rng(SEED)
    real = rng.standard_normal(STATION).astype(np.float32)
    t = np.arange(STATION) / STATION
    pilot = (np.sin(2 * np.pi * 19e3 * t + 0.3)
             + 0.01 * rng.standard_normal(STATION)).astype(np.float32)

    def both(make, *inputs):
        outs = []
        for dev in (None, "cpu"):   # None: the default device, the card
            obj = make(dev)
            out = [obj.run(x) for x in inputs]
            outs.append([torch.as_tensor(o).cpu() for o in out])
        return outs

    cases = {
        "FM": both(lambda d: models.FM(STATION, AUDIO, device=d), iq),
        "MFM": both(lambda d: models.MFM(STATION, AUDIO, device=d), iq, iq),
        "WBFM": both(lambda d: models.WBFM(STATION, AUDIO, device=d), iq, iq),
        "Decimate real": both(
            lambda d: models.Decimate(STATION, AUDIO, device=d), real),
        "Decimate complex": both(
            lambda d: models.Decimate(STATION, AUDIO, device=d), iq),
        "Bandpass": both(lambda d: models.Bandpass(
            STATION, 19e3 - 50, 19e3 + 50, num_taps=41, device=d), real),
        "Deemphasis": both(
            lambda d: models.Deemphasis(STATION, device=d), real, real),
    }
    for name, (card, cpu) in cases.items():
        err = max(max_abs(a, b) for a, b in zip(card, cpu))
        print(f"[classes] {name} {tuple(card[-1].shape)} card vs CPU "
              f"max_abs {err:.3e} (bound {E2E_ABS_MAX:.0e})")
        if not err <= E2E_ABS_MAX:
            raise AssertionError(f"{name}: card and CPU differ by {err}")
    errs = []
    for dev in (None, "cpu"):
        pll = models.PLL(device=dev)
        pll.step(pilot)
        errs.append([pll.real(2).cpu(), pll.image(2).cpu()])
    err = max(max_abs(a, b) for a, b in zip(*errs))
    print(f"[classes] PLL harmonics 2 card vs CPU max_abs {err:.3e} (bound "
          f"{E2E_ABS_MAX:.0e})")
    if not err <= E2E_ABS_MAX:
        raise AssertionError(f"PLL: card and CPU differ by {err}")

    # Routes chosen by dtype and size, before any kernel.
    band = crandn(gen, device, N_BAND).to(torch.complex128)
    if offt.route_name(N_BAND, band.dtype, True) != "torch":
        raise AssertionError("a complex128 band routes to a kernel")
    err = rel_l2(offt.fft(band), torch.fft.fft(band))
    del band
    x = torch.randn(4, 65_536, generator=gen, device=device)
    hist64 = torch.randn(4, 50, generator=gen, device=device,
                         dtype=torch.float64)
    taps = np.asarray(rng.standard_normal(51) / 51)
    fir.launches.reset()
    e_hist = max_abs(fir_causal(x, taps, hist64),
                     fir.fir_causal_plain(x.double(), taps, hist64))
    long_taps = np.asarray(rng.standard_normal(5000) / 5000)
    route = fir_route(x, long_taps, "kernel")
    e_long = max_abs(fir_causal(x, long_taps, impl="kernel"),
                     fir.fir_causal_plain(x.double(), long_taps))
    print(f"[classes] routes: complex128 2^24 band through ops/fft.fft "
          f"rel_l2 {err:.3e}; float64 history through K-FIR "
          f"({fir.launches.count} launch) max_abs {e_hist:.3e}; 5000 taps "
          f"-> {route!r} max_abs {e_long:.3e} (bound {FIR_ABS_MAX:.0e})")
    if (fir.launches.count != 1 or route != "fft" or err > 1e-12
            or not max(e_hist, e_long) <= FIR_ABS_MAX):
        raise AssertionError("a route chosen by dtype or size is wrong")


def check_dead_step(device, gen) -> None:
    """Phase 13: whole steps on a 64-station spectrum in which two
    stations' bins are exactly zero, in all three ``extract_demod``
    modes: the dead stations' audio is finite and, like the live
    stations', equal to the port's on the CPU."""
    import torch
    from radiocore_tpu_torch.ops.channelize import uniform_extraction_start

    c, m, n = N_STATIONS, STATION, N_BAND
    dead = [c // 2, c - 1]
    live = [i for i in range(c) if i not in dead]
    spec = torch.fft.fft(fm_band(gen, c, m, device))
    a0 = uniform_extraction_start(n, tuple(-o for o in offsets(c, m)), m)
    for i in dead:
        bins = (a0 + i * m + torch.arange(m + 1, device=device)) % n
        spec[bins] = 0
    spec_cpu = spec.cpu()
    failures = []
    for xd in ("off", "fused", "spec"):
        audio = {}
        for dev, sp in ((device, spec), ("cpu", spec_cpu)):
            step, state = _fast_step(c, dev, xd)
            _, middle, last = step.stages.values()
            audio[str(dev)], _ = last(middle(sp), state)
        card, cpu = audio[str(device)].cpu(), audio["cpu"]
        finite = bool(torch.isfinite(card[dead]).all())
        e_dead = max_abs(card[dead], cpu[dead]) if finite else float("nan")
        e_live = max_abs(card[live], cpu[live])
        print(f"[dead] step extract_demod={xd!r}, stations {dead} zeroed: "
              f"their audio finite {finite}, card vs CPU max_abs "
              f"{e_dead:.3e}, live stations {e_live:.3e} (bound "
              f"{E2E_ABS_MAX:.0e})")
        if not (finite and e_dead <= E2E_ABS_MAX and e_live <= E2E_ABS_MAX):
            failures.append(f"{xd}: finite {finite}, dead {e_dead}, live "
                            f"{e_live}")
    if failures:
        raise AssertionError("dead stations through a whole step: "
                             + "; ".join(failures))


# ---------------------------------------------------------------------------
# Phase 14: the apps' path and the host edge under it.
# ---------------------------------------------------------------------------

APPS_CHUNKS = 8          # serve_fused chunks (two file chunks, looped)
INGEST_CHUNKS = 4        # distinct host chunks per size in [ingest]
RX_SECONDS = 5           # receive_fm on the card
RX_CPU_SECONDS = 2       # and on the CPU, from the same source seed
SERVE_ABS_MAX = 1e-6     # server audio against the same step, band on card
SYNTH_F64_MAX = 5e-4     # stereo_fm_iq against float64 (tests/test_torch_synth)


def _merged(intervals):
    """Union of ``[(start, end)]`` as sorted, disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def copy_overlap(events, count):
    """Share of the time of the ``count`` longest host-to-device copies
    (``Memcpy HtoD`` events) that other device work overlaps, and the
    number of such copies in ``events``."""
    copies = sorted(((a, b) for a, b, n in events if "Memcpy HtoD" in n),
                    key=lambda ab: ab[0] - ab[1])
    n_copies = len(copies)
    copies = copies[:count]
    busy = _merged((a, b) for a, b, n in events if "Memcpy" not in n)
    total = sum(b - a for a, b in copies)
    both = sum(max(0.0, min(b, y) - max(a, x))
               for a, b in copies for x, y in busy)
    return (both / total if total else 0.0), n_copies


def _median_rates(records):
    """Median host->pinned and H2D rates (GB/s) of a pipe's copies."""
    host = statistics.median(r.nbytes / r.host_s for r in records) / 1e9
    h2d = statistics.median(r.nbytes / r.h2d_ms() * 1e3 for r in records)
    return host, h2d / 1e9


def check_ingest(device, gen) -> dict:
    """``IngestPipe`` over pageable NumPy chunks of 2^24 and 96 · 2^18
    complex64 at depths 1, 2 and 3: every yielded chunk equal to its host
    chunk bit for bit (compared on the consumer's stream, with no wait in
    between), the host->pinned memcpy and the H2D copy apart, and at
    depth 2 against 1 the share of the copies that the ``fast`` step of
    the chunk before overlaps, from the ``torch.profiler`` timeline."""
    import torch
    from radiocore_tpu_torch.runtime.ingest import IngestPipe

    host = {}
    for n in (N_BAND, N_BAND_96):
        refs = [crandn(gen, device, n) for _ in range(INGEST_CHUNKS)]
        host[n] = ([r.cpu().numpy() for r in refs], refs)
    for n, (chunks, refs) in host.items():
        for depth in (1, 2, 3):
            pipe = IngestPipe(depth=depth, device=device)
            wrong = torch.zeros((), dtype=torch.int64, device=device)
            seq = [i % INGEST_CHUNKS for i in range(3 * INGEST_CHUNKS)]
            for band, i in zip(pipe.stream(chunks[i] for i in seq), seq):
                scratch = band * 2.0      # allocate on the consumer stream
                wrong += (band != refs[i]).sum() + (scratch != 2 * refs[i]).sum()
            torch.cuda.synchronize()
            h, d = _median_rates(pipe.stager.records)
            print(f"[ingest] {n} c64 ({chunks[0].nbytes / 1e6:.0f} MB) depth "
                  f"{depth}, {len(seq)} chunks: {int(wrong)} elements differ "
                  f"from their host chunk; host->pinned {h:.2f} GB/s, H2D "
                  f"{d:.2f} GB/s (medians, CUDA events on the copy stream)")
            if int(wrong):
                raise AssertionError(f"ingest {n} depth {depth}: {int(wrong)} "
                                     f"elements differ")
    del host[N_BAND_96]
    chunks = host[N_BAND][0]
    step, state0 = _fast_step(N_STATIONS, device)
    shares = {}
    for depth in (1, 2):
        pipe = IngestPipe(depth=depth, device=device)

        def stream_through_step():
            state = state0
            for band in pipe.stream(chunks):
                _, state = step(band, state)

        shares[depth], copies = copy_overlap(traced(stream_through_step, 1),
                                             INGEST_CHUNKS)
        if copies < INGEST_CHUNKS:
            raise AssertionError(f"ingest trace: {copies} HtoD copies, "
                                 f"expected {INGEST_CHUNKS} or more")
    print(f"[ingest] {N_BAND} through the fast step, {INGEST_CHUNKS} chunks "
          f"(torch.profiler): share of the H2D copies' time overlapped by "
          f"compute: depth 2 {shares[2]:.3f}, depth 1 {shares[1]:.3f}")
    if not shares[2] > 0.0:
        raise AssertionError("ingest: at depth 2 no copy overlaps a step")
    return host[N_BAND][0]


def check_tuner(device, gen) -> None:
    """``Tuner.load`` + ``run_all`` at the main plan against ``run(i)``
    for four channels and a complex128 reference; the K-FFT and K-EXTRACT
    counters move by one band FFT and one extraction."""
    import tempfile
    import numpy as np
    import torch
    from radiocore_tpu_torch.kernels import extract, fft_rows
    from radiocore_tpu_torch.ops import design
    from radiocore_tpu_torch.ops import fft as offt
    from radiocore_tpu_torch.ops.channelize import make_extractor
    from radiocore_tpu_torch.ops.resample import resample_spectrum
    from radiocore_tpu_torch.runtime.profiling import device_trace
    from radiocore_tpu_torch.tools.tuner import Tuner

    f0 = 100e6
    tuner = Tuner(device=device)
    for off in offsets(N_STATIONS, STATION):
        tuner.add_channel(f0 + off, STATION, None)
    if (tuner.input_frequency, tuner.input_bandwidth) != (f0, N_BAND):
        raise AssertionError(f"band plan {tuner.input_frequency}, "
                             f"{tuner.input_bandwidth}")
    band = fm_band(gen, N_STATIONS, STATION, device)
    shifts = tuple(-o for o in offsets(N_STATIONS, STATION))
    counters = (fft_rows.launches, extract.launches)
    torch.cuda.synchronize()
    for ctr in counters:
        ctr.reset()
    spectrum = offt.fft(band)
    one_fft = fft_rows.launches.count
    make_extractor(N_BAND, shifts, STATION)(spectrum)
    one_extract = extract.launches.count
    del spectrum
    for ctr in counters:
        ctr.reset()
    tuner.load(band)
    rows = tuner.run_all()
    torch.cuda.synchronize()
    counts = (fft_rows.launches.count, extract.launches.count)
    if counts != (one_fft, one_extract) or 0 in counts:
        raise AssertionError(f"Tuner launches K-FFT, K-EXTRACT {counts}, "
                             f"one band FFT and extraction "
                             f"{(one_fft, one_extract)}")
    ms = time_ms(lambda: (tuner.load(band), tuner.run_all()), reps=10)
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            tuner.load(band)
            tuner.run_all()
        trace = json.loads(next(Path(tmp).glob("*.json")).read_text())
    kernels = [ev["name"] for ev in trace["traceEvents"]
               if ev.get("cat") == "kernel"]
    if not any("pass_kernel" in name for name in kernels):
        raise AssertionError(f"device_trace: no pass kernel among "
                             f"{len(kernels)} kernel events")
    x64 = torch.fft.fft(band.to(torch.complex128))
    win = torch.from_numpy(np.fft.fftshift(design.window("hann", N_BAND))).to(
        device)
    errs = []
    for i in (0, N_STATIONS // 3, N_STATIONS // 2, N_STATIONS - 1):
        ref = resample_spectrum(torch.roll(x64, shifts[i]) * win, STATION)
        one = tuner.run(i)
        errs.append((rel_l2(rows[i], ref), rel_l2(one, ref),
                     rel_l2(rows[i], one.to(torch.complex128))))
    run_ms = time_ms(lambda: tuner.run(1), reps=5)
    worst = max(max(e[:2]) for e in errs)
    print(f"[tuner] {N_STATIONS} x {STATION} from a 2^24 band: load + run_all "
          f"{ms:.3f} ms, launches K-FFT {counts[0]}, K-EXTRACT {counts[1]} "
          f"(= one band FFT, one extraction; runtime.profiling.device_trace "
          f"of one load + run_all: {len(kernels)} kernel events); run(i) "
          f"{run_ms:.3f} ms a "
          f"channel; four channels rel_l2 against complex128 run_all "
          f"{max(e[0] for e in errs):.3e}, run(i) {max(e[1] for e in errs):.3e}"
          f", run_all vs run(i) {max(e[2] for e in errs):.3e} (bound "
          f"{REL_L2_MAX:.0e})")
    if not worst <= REL_L2_MAX:
        raise AssertionError(f"tuner: rel_l2 {worst}")


class ListSink:
    """Keeps every chunk of audio it is given."""

    def __init__(self):
        self.chunks = []

    def write(self, audio):
        import numpy as np
        self.chunks.append(np.array(audio, copy=True))

    def close(self):
        pass


def check_serve_fused(device, gen, main_step) -> None:
    """``multi_fm_server.serve_fused`` at full width from a cf32 capture
    (two seconds of FM stations, one of them the real station), as the
    reference's server loop runs it with ``--no-zmq``."""
    import tempfile
    import numpy as np
    import torch
    from radiocore_tpu_torch.apps.iq import IQFileSource, write_iq_file
    from radiocore_tpu_torch.apps.multi_fm_server import (StationSpec,
                                                          serve_fused)
    from radiocore_tpu_torch.runtime.metrics import Metrics
    from radiocore_tpu_torch.runtime.profiling import StageTimer

    slot = N_STATIONS // 3
    bands = [fm_band(gen, N_STATIONS, STATION, device, real_slot=slot)
             for _ in range(2)]
    f0 = 100e6
    specs = [StationSpec(f0 + off, "wbfm", STATION)
             for off in offsets(N_STATIONS, STATION)]
    # The launches of one step, from the same step on a band on the card.
    step, state = _fast_step(N_STATIONS, device)
    counters = path_counters(N_STATIONS, "off")
    torch.cuda.synchronize()
    for ctr in counters.values():
        ctr.reset()
    step(bands[0], state)
    torch.cuda.synchronize()
    per_step = {name: ctr.count for name, ctr in counters.items()}
    refs = []
    for k in range(APPS_CHUNKS):
        audio, state = step(bands[k % 2], state)
        refs.append(audio.cpu().numpy())
    sinks = [ListSink() for _ in specs]
    metrics, timer = Metrics(), StageTimer()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/band.cf32"
        t0 = time.perf_counter()
        write_iq_file(path, torch.cat(bands).cpu().numpy())
        write_s = time.perf_counter() - t0
        source = IQFileSource(path, N_BAND)
        torch.cuda.synchronize()
        for ctr in counters.values():
            ctr.reset()
        t0 = time.perf_counter()
        serve_fused(specs, N_BAND, AUDIO, source, APPS_CHUNKS, sinks=sinks,
                    metrics=metrics, mode="fast", timer=timer, device=device)
        wall = time.perf_counter() - t0
    counts = {name: ctr.count for name, ctr in counters.items()}
    want = {name: APPS_CHUNKS * c for name, c in per_step.items()}
    err = max(float(np.abs(s.chunks[k] - refs[k][i]).max())
              for i, s in enumerate(sinks) for k in range(APPS_CHUNKS))
    rep = timer.report()
    staged = sum(v["total_s"] for v in rep.values())
    rate = APPS_CHUNKS / wall
    print(f"[serve_fused] {N_STATIONS} x {STATION} -> {AUDIO} from a cf32 "
          f"capture ({write_s:.2f} s to write), {APPS_CHUNKS} chunks in "
          f"{wall:.3f} s: {rate:.2f} chunks/s, {N_STATIONS * rate:.0f} "
          f"real-time channels with host ingest; device-only step of [main] "
          f"{main_step['min_ms']:.3f} ms = "
          f"{N_STATIONS * 1e3 / main_step['min_ms']:.0f} channels")
    print("[serve_fused] stage means: " + ", ".join(
        f"{k} {v['mean_ms']:.2f} ms" for k, v in rep.items())
        + f"; between stages (the pipe's host memcpy into its slot, the "
          f"copy's launch) {(wall - staged) * 1e3 / APPS_CHUNKS:.2f} ms")
    print(f"[serve_fused] launches {counts} (= {APPS_CHUNKS} x one step "
          f"{per_step}); audio against the same step on the bands already "
          f"on the card max_abs {err:.3e} (bound {SERVE_ABS_MAX:.0e})")
    if counts != want:
        raise AssertionError(f"serve_fused launches {counts}, want {want}")
    if not err <= SERVE_ABS_MAX:
        raise AssertionError(f"serve_fused audio off by {err}")
    check_tones("serve_fused", f"slot {slot}, last chunk",
                sinks[slot].chunks[-1].astype(np.float64))


def check_receive_fm(device) -> None:
    """``receive_fm.run`` at the CLI's defaults (2.4 MS/s -> 240 kS/s ->
    48 kHz, exact WBFM, SyntheticFmSource) on the card, and its first
    chunks against the port on the CPU from the same source seed."""
    import numpy as np
    from radiocore_tpu_torch.apps import receive_fm as rx
    from radiocore_tpu_torch.apps.iq import SyntheticFmSource
    from radiocore_tpu_torch.kernels import fir
    from radiocore_tpu_torch.runtime.config import (PipelineConfig,
                                                    StationConfig)
    from radiocore_tpu_torch.runtime.metrics import Metrics
    from radiocore_tpu_torch.runtime.profiling import StageTimer

    config = PipelineConfig(input_rate=2.4e6, demod_rate=240e3,
                            audio_rate=48e3,
                            stations=(StationConfig(96.9e6, 240e3, "wbfm"),))

    def source():
        return SyntheticFmSource(int(config.input_rate), [0],
                                 int(config.demod_rate),
                                 tones=[(440.0, 1000.0)], seed=SEED)

    sinks = {}
    for where, secs in ((device, RX_SECONDS), ("cpu", RX_CPU_SECONDS)):
        sinks[where] = sink = ListSink()
        metrics, timer = Metrics(), StageTimer()
        fir.launches.reset()
        t0 = time.perf_counter()
        rx.run(config, source(), sink, secs, metrics, timer,
               wbfm_mode="exact", ring_seconds=secs + 1, device=where)
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        print(f"[receive_fm] on {where}: {len(sink.chunks)} s in {wall:.2f} s,"
              f" realtime x{snap['realtime_factor']:.2f}, overflows "
              f"{int(snap['ring_overflows'])}, K-FIR launches "
              f"{fir.launches.count}; stage means " + ", ".join(
                  f"{k} {v['mean_ms']:.2f} ms"
                  for k, v in timer.report().items()))
        if len(sink.chunks) != secs or snap["ring_overflows"]:
            raise AssertionError(f"receive_fm on {where}: {len(sink.chunks)} "
                                 f"chunks, {snap['ring_overflows']} overflows")
        if where == device:
            fir_count = fir.launches.count
    card, cpu = sinks[device].chunks, sinks["cpu"].chunks
    err = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
    print(f"[receive_fm] first {len(cpu)} chunks card vs CPU max_abs "
          f"{err:.3e} (bound {E2E_ABS_MAX:.0e})")
    if not err <= E2E_ABS_MAX:
        raise AssertionError(f"receive_fm: card and CPU differ by {err}")
    check_tones("receive_fm", "last chunk", card[-1].astype(np.float64),
                fs=int(config.audio_rate))
    if fir_count <= 0:
        raise AssertionError("receive_fm: K-FIR never launched")


def check_native(chunk) -> None:
    """The native ring and IQ converter build on the card's machine; the
    ring's put and get rates for one 2^24 complex64 chunk."""
    import numpy as np
    from radiocore_tpu_torch.native import iq_convert_native
    from radiocore_tpu_torch.tools.ringbuffer import RingBuffer

    ring = RingBuffer(2 * chunk.size, dtype="complex64", print_overflow=False)
    conv = iq_convert_native(np.zeros(8, np.int16), "cs16")
    if ring.backend != "native" or conv is None:
        raise AssertionError(f"native: ring backend {ring.backend!r}, "
                             f"converter {conv is not None}")
    out = np.empty_like(chunk)
    put, get = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        ring.put(chunk)
        t1 = time.perf_counter()
        ring.get(out)
        get.append(time.perf_counter() - t1)
        put.append(t1 - t0)
    if not np.array_equal(out, chunk):
        raise AssertionError("native ring: data differs")
    print(f"[native] RingBuffer backend 'native', iq_convert_native built; "
          f"{chunk.nbytes / 1e6:.0f} MB chunk: put "
          f"{chunk.nbytes / statistics.median(put) / 1e9:.2f} GB/s, get "
          f"{chunk.nbytes / statistics.median(get) / 1e9:.2f} GB/s "
          f"(medians of 5)")


def check_synth(device) -> None:
    """``stereo_fm_iq`` at 262 144 on the card against the float64
    oracles."""
    import numpy as np
    from oracles import make_fm_iq, make_stereo_multiplex
    from radiocore_tpu_torch.ops.synth import stereo_fm_iq

    got = stereo_fm_iq(STATION, float(STATION), 440.0, 1000.0, device=device)
    ref = make_fm_iq(make_stereo_multiplex(STATION, STATION, 440.0, 1000.0),
                     0.25)
    err = float(np.abs(got.cpu().numpy() - ref).max())
    print(f"[synth] stereo_fm_iq {STATION} on the card against float64 "
          f"max_abs {err:.3e} (bound {SYNTH_F64_MAX:.0e})")
    if not err <= SYNTH_F64_MAX:
        raise AssertionError(f"synth: {err}")



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    from radiocore_tpu_torch.kernels import build
    from radiocore_tpu_torch.runtime.platform import nvidia_smi_name_power

    t_start = t_lap = time.perf_counter()

    def lap(what):
        nonlocal t_lap
        now = time.perf_counter()
        print(f"[smoke] {what}: {now - t_lap:.1f} s")
        t_lap = now

    smi = nvidia_smi_name_power()
    if not smi:
        raise RuntimeError("nvidia-smi gave no card name and power limit")
    print(smi.splitlines()[0])
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    try:
        import triton
        triton_state = f"triton {triton.__version__} imports"
    except ImportError:
        triton_state = "triton does not import"
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}, {triton_state}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    device = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")

    # Phase 1: build.
    t0 = time.perf_counter()
    res = build.build()
    build.library()
    print(f"[build] nvcc sm_90a: {res.seconds:.1f} s compile, "
          f"{time.perf_counter() - t0:.1f} s total -> "
          f"{res.path.relative_to(REPO)}")
    for line in res.log.splitlines():
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            print(f"[build] {line.strip()}")
    check_spills(res.log)
    lap("start and build")

    gen = torch.Generator(device=device).manual_seed(SEED)
    kstats, launches, main_step = {}, {}, {}

    def phase_main():
        # Phase 2: kernels against their plain versions.
        kstats.update(check_kernels(device, gen))
        lap("kernels at the main shapes")
        # Phase 3: the main path.
        step, state, band1, audio1, counts = run_main_path(device, gen)
        launches.update(counts)
        print(f"[main] {N_STATIONS} x {STATION} -> {AUDIO}, {CHUNKS} chunks: "
              f"audio {tuple(audio1.shape)} finite; launches {counts}")
        band = fm_band(gen, N_STATIONS, STATION, device)
        stages = stage_ms(step, band, state)
        print(f"[main] {step_ms(step, band, state, main_step)}; stages "
              f"(median of 20) "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items()))
        profile_step("main", step, band, state)
        against_cpu("main", N_STATIONS, band1, audio1)
        # Phase 4: one real station.
        check_station("station", step, N_STATIONS, device)
        lap("main path and station")

    def phase_band():
        # Phase 5: the 96-station kernels against their plain versions.
        kstats.update(check_band_kernels(device, gen))
        lap("kernels at the 96-station shapes")

    def phase_dead():
        # Phase 6: the discriminator alone, and dead stations.
        check_discriminator(device, gen)
        check_dead_stations(device, gen)
        lap("discriminator and dead stations")

    def phase_paths96():
        # Phase 7: the 96-station paths, the spec path first.
        c = N_STATIONS_96
        for xd, chunks in (("spec", CHUNKS), ("fused", CHUNKS_MODES),
                           ("off", CHUNKS_MODES)):
            what = f"96 {xd}"
            step, state, band1, audio1, counts = run_main_path(
                device, gen, c=c, chunks=chunks, extract_demod=xd)
            print(f"[{what}] {c} x {STATION} -> {AUDIO}, {chunks} chunks: "
                  f"audio {tuple(audio1.shape)} finite; launches {counts}")
            for name, count in counts.items():
                launches.setdefault(name, count)
            band = fm_band(gen, c, STATION, device)
            line = f"[{what}] {step_ms(step, band, state)}"
            if xd == "spec":
                line += "; stages (median of 20) " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in stage_ms(step, band,
                                                           state).items())
            print(line)
            if xd == "spec":
                profile_step(what, step, band, state)
            against_cpu(what, c, band1, audio1, xd)
            if xd == "spec":
                check_station(what + " station", step, c, device, xd)
            del step, state, band1, audio1, band
            lap(f"path {what}")

    def phase_nco():
        kstats["K-NCO"] = check_nco(device, gen)
        lap("K-NCO")

    def phase_firpilot():
        check_fir_pilot(device, gen)
        lap("K-FIR at the pilot bandpass")

    def phase_exact():
        run_exact_path(device, gen, launches)
        lap("path exact")

    def phase_ncopath():
        run_nco_paths(device, gen, launches)
        lap("paths nco")

    def phase_classes():
        check_classes(device, gen)
        lap("classes and routes")

    def phase_deadstep():
        check_dead_step(device, gen)
        lap("dead stations through whole steps")

    def phase_apps():
        # Phase 14: the apps' path and the host edge under it.
        chunk = check_ingest(device, gen)[0]
        lap("[ingest]")
        check_tuner(device, gen)
        lap("[tuner]")
        check_serve_fused(device, gen, main_step)
        lap("[serve_fused]")
        check_receive_fm(device)
        lap("[receive_fm]")
        check_native(chunk)
        check_synth(device)
        lap("[native] and [synth]")

    for run_phase in (phase_main, phase_band, phase_dead, phase_paths96,
                      phase_nco, phase_firpilot, phase_exact, phase_ncopath,
                      phase_classes, phase_deadstep, phase_apps):
        run_phase()

    print(f"[smoke] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name.split()[0]], **kstats[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

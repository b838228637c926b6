#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``radiocore_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds the hand-written kernels from ``radiocore_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a``;
2. runs K-FFT (rows, the planar wrapper, band, rfft, and the
   ``ifft_pow2`` and ``irfft_pow2`` wrappers), K-EXTRACT and K-FIR (51
   taps at the main path's shape, timed before and after the FFT
   kernels; 129 taps; a ragged length through a strided view) at the
   main path's shapes against their plain PyTorch versions on the card,
   and times both, beside each
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
   in a 2^24 band and checks both tones' SNR; then runs K-GATHER at the
   benchmark's wbfm24 plan (24 stations of 240 000 points in a 10^7-bin
   spectrum) against its plain version in complex128, times it and the
   torch reorder it replaces (device time after an L2 flush) beside its
   bound, times the extraction stage as a CUDA graph under ``auto`` and
   ``native``, and counts its launches a step of the ``off`` step in
   ``fast`` and ``exact`` (one each, no K-EXTRACT); then K-QDEMOD, the
   quadrature demod, at the wbfm24 cells' 24 x 240 000 and at a mix
   group's 8 rows of it, on FM station IQ, against its plain version (the
   torch chain): samples that differ, the largest gap, the device time of
   both after an L2 flush and back to back, beside its bytes bound; then
   K-BANDFFT, the 10^7-point band transform, at 1 and 2 rows, and at the
   other size it is routed, 3200², against cuFFT in complex128 (both
   signs, beside cuFFT's own complex64 error), its two passes' and
   cuFFT's device times after an L2 flush beside the bytes bound, and its
   launches a replayed wbfm24 step;
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
8. runs K-NCO (the feedback pilot loop), one kernel with two outputs. Its
   phase output (``nco_pll_track_rows``) against its plain PyTorch loop
   at 8 x 4096 and on rows off a 16-byte boundary (each with a NaN row
   and a row started 8 turns away), the float32 scan's distance beside
   it, and at 64 x 262 144, on rms-normalised 19 kHz pilots with a
   frequency offset and noise, against a float64 model of the loop for a
   few rows, beside the float32 scan's own distance, modulo 2 pi; prints
   each instantiation's opcodes and the md5 of its instruction text from
   ``cuobjdump -sass``; times the phase output at 64 x 262 144 and
   24 x 240 000 and the probe's chains (``rc_nco_chain_probe``: the bare
   recurrence, the sample without memory, the chain lane's sample through
   shared memory), each with one and 32 lanes; then the subcarrier output
   the nco step launches (``nco_pll_subcarrier_rows``) against its plain
   loop on the same pilots at 64 x 262 144 over two chunks (acquiring,
   then from the carried state), on rows off a 16-byte boundary at an odd
   length and at a 5 kHz loop (the tiles each redoes counted alike),
   timed at 64 x 262 144 and 24 x 240 000 beside its bytes bound and the
   chain's latency, with its cycles a sample and the tiles its timed
   calls redid and found not yet staged (``redone``, ``starved``);
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
15. runs the parallel layer in a world of two ranks on this card over
    ``gloo`` (``[parallel]``): ``make_multi_station_step(mesh=...)`` in
    ``fast`` and ``exact`` at the main plan over 3 chained chunks through
    the distributed front end (gathered audio against the one-process
    step on the card, the front end's station IQ against complex128,
    each rank's launches, collective bytes and times, step wall times),
    the all-gather branch at 62 stations, the config-5 plan (128 x 50 000
    in ``exact`` and ``fast``, against the one-process step, the tones of
    stations 0, 64 and 127), the config-4 form (a 129-tap
    halo overlap-save FIR and the distributed extraction of 64 channels),
    ``fir_causal_sharded`` at 51 taps over 2^24 against K-FIR, and
    ``pfb_channelize_halo`` (64 channels, P = 8) over two chunks against
    the unsharded channelizer. A rank that fails fails the run.
16. (run after 13) drives ``make_multi_station_step`` under explicit
    ``Routes`` (``runtime/routes.py``, never the environment): ``fast`` at
    64 x 262 144 with ``extract_ifft`` = ``native``, ``fourstep`` and
    ``pallas`` (K-FFT's ``fft_pow2`` backward instead of K-EXTRACT),
    ``station_rfft="native"``, ``env_fft="pallas"`` and ``fir_impl`` =
    ``fft`` and ``conv``; ``exact`` with ``fft_kernel_min = 2^16`` (the
    tail's transforms on K-FFT's ``fft_pow2``, ``ifft_pow2``,
    ``rfft_pow2`` and ``irfft_pow2``); ``fast`` at 96 x 262 144 with
    ``fft_mixed_min = 0``. Each over 2 chained chunks: step time (min and
    median of 10, CUDA events) beside the card's name and power limit,
    launches by kernel and K-FFT entry (the kernel a route replaces must
    launch 0 times, the entry it adds more than on the default routes),
    audio within 1e-4 of the default routes' on the same chunks; and the
    three extraction routes on a spectrum with two dead stations (their
    IQ and quad exactly 0: ``[routes] dead``). In the JSON line each
    K-FFT entry's ``launches`` is the count of the first run that made
    any (``launches_run``: the main path for ``rfft_pow2``), beside every
    run's own count (``launches_by_run``).
17. (run after 14) runs the port's acceptance drive,
    ``radiocore_tpu_torch.tools.acceptance``, with every config on the
    card (``[acceptance]``): BASELINE.md's acceptance configs 1-4 and the
    fidelity configs 1-3 against the float64 oracle chain of
    ``tests/oracles.py``, each check with the launches of the kernels its
    path must go through; a FAIL fails the run.
18. drives the config-5 rehearsal of ``tests/test_config5.py`` in one
    process (``[config5]``): ``make_multi_station_step`` at 128 x 50 000
    -> 10 000 (a 6.4 M band of ``SyntheticFmSource`` stations) in
    ``exact`` and ``fast``, on the plain extraction and cuFFT (launches:
    K-FIR twice a step for the exact pilot filter, no other kernel; the
    de-emphasis of 10 000 samples is below K-FIR's minimum length), the
    card against the port on the CPU (1e-4),
    the tones of stations 0, 64 and 127 (> 6 dB), the step time.

19. (run after 16) holds every compiled step (``runtime/graphs``: on the
    card each step the JAX package jits is captured once per signature as
    a CUDA graph and replayed) against its eager body, ``step.eager``
    (``[graphs]``): the main plan in ``fast`` and ``exact``, ``fir_impl``
    ``fft`` and ``conv``, ``exact`` with ``fft_kernel_min = 2^16``, 96
    stations in ``off``, ``fused`` and ``spec``, the ``nco`` step at 64
    stations, config 5 in both modes, ``Decimate``, ``WBFM``, ``MFM`` and
    ``FM`` at ``receive_fm``'s defaults, and the Tuner's band FFT,
    ``run_all`` and ``run(i)``. Each on two chained chunks: outputs bit
    for bit (or within 1e-6 of the max), launches a call by kernel and
    K-FFT entry equal to eager's, chunk 1's outputs unchanged by chunk 2,
    two calls from one state equal; the min and median device ms of 10
    steps and the host's enqueue of one, graph and eager; the inputs'
    copy-in and the outputs' clone-out; ``max_memory_reserved``.

20. (run after 4) builds the mixed24 cell's step
    (``make_multi_station_step(kinds=...)``: 24 x 240 000 on the 10 MS/s
    band of ``portbench/signals.band_pool``, WBFM, MFM and FM in
    rotation, WBFM ``exact``) on the card (``[mixed]``): ``step.rows``;
    one replayed step's launches (K-GATHER 1, K-EXTRACT 0, K-FIR 4, each
    kind's ``pipeline.demodulated`` counter its 8 rows), three replays'
    and one graph; the step and stage times; K-GATHER on the permuted
    plan (rows WBFM, MFM, FM) against its plain version in complex128,
    and the step's extraction against the station-order one with its
    rows permuted; K-FIR at the MFM group's 8 x 48 000 against float64;
    two chained chunks, audio and carried histories, against the same
    step on the CPU (1e-4).

21. (run after 20) builds the wbfm48_2band cell's step
    (``make_multi_station_step(bands=...)``: two 10 MS/s bands of 24
    stations of 240 000 S/s, each band with its own plan, ``fast``, on
    the pools of ``portbench/bands.band_pools``) on the card
    (``[bands]``): ``step.band_rows``; one replayed step's launches
    (K-GATHER 1, K-EXTRACT 0, K-QDEMOD 1, K-FIR 1, ``pipeline.bands``
    2), three replays' and one graph; the step time and each stage
    alone; K-GATHER with two plans against its plain version in
    complex128 and each band's rows against the one-plan gather of that
    band alone (bit for bit); two chained chunks, audio and carried
    histories, against the same step on the CPU (1e-4).

Every phase above drives the entry points a user calls, so on the card
their steps are the compiled ones: the step times, launches and
``[… ] profile`` lines are those of graph replays (``torch.profiler``
lists a replay's kernels); ``stage_ms`` times ``step.stages``, which
stay eager.

The build fails the run if ``ptxas`` reports register spills for the
demod pass of K-XDEMOD(-SPEC), for K-FIR's kernel or for K-NCO's.

Every phase raises on failure. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result. The
last line is ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --paths TAG [TREE]`` drives only the default
paths (``fast`` and ``exact`` at 64 x 262 144, ``extract_demod="spec"``
at 96 x 262 144, 2 chained chunks each) of the package in ``TREE`` (a
checkout, such as a parent commit unpacked with ``git archive``; this
one by default): each path's step time and launches, and the SHA-256 of
its audio, written to ``chiprun_out/paths/TAG.json``. ``python3
chip_smoke.py --compare TAG TAG`` says whether two such runs gave the
same audio bit for bit and the same launches (exit 1 if not). Run the
trees in turns (parent, change, change, parent) on one card.
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
# K-QDEMOD against the torch chain: torch's complex product contracts into
# FMAs apart from the kernel's in about a third of the samples, which moves
# the angle by an ulp or two.
QDEMOD_ABS_MAX = 2.4e-7
E2E_ABS_MAX = 1e-4    # card against CPU, audio of chunk 1
SNR_MIN_DB = 20.0     # per stereo tone, as the repository's verify drive
# K-NCO against its plain loop (the same arithmetic in float32; the kernel
# fuses multiply-adds): two float32 loops that round differently drift
# apart by about 1e-5 rad before the loop's feedback pulls them back.
# Against the float64 model the loop's feedback holds float32 rounding
# down (the float32 scan itself is printed beside the kernel).
NCO_PLAIN_MAX = 5e-5  # rad, modulo 2 pi
NCO_F64_MAX = 2e-4    # rad, modulo 2 pi
NCO_SHORT = (8, 4096)
NCO_DEAD = 3          # a NaN pilot row in the short check
NCO_WILD = 5          # a row started 8 turns away (about -+50 rad)
# K-NCO's subcarrier output (what the nco step launches) against its plain
# loop: the phase as above, the subcarrier -sin 2p by twice that.
NCO_SUB_MAX = 2 * NCO_PLAIN_MAX
NCO_OFF_N = 48_003    # an odd length, rows off a 16-byte boundary
# Acquiring from a random phase, two float32 loops part by up to about
# 1e-3 before the feedback pulls them together (within 13 000 samples on
# these pilots; a float32 loop and the float64 one part as far): the
# acquiring chunk's subcarrier is held from this sample on.
NCO_ACQUIRE = 65_536
NCO_WIDE_HZ = 5000.0  # a loop whose psi passes the series' limit
FAST_EXACT_MIN_DB = 40.0   # fast against exact audio on a real station

# Published peaks of one H100 SXM: the yardstick of each kernel's bound.
# The plan of the benchmark's cells (portbench/configs/wbfm24_*.json): 24
# stations of 240 000 S/s, 400 kHz apart, symmetric about the centre of a
# 10 MS/s band; not a uniform power-of-two plan, so K-GATHER extracts it.
W24_BAND, W24_STATION, W24_AUDIO = 10_000_000, 240_000, 48_000
W24_OFFSETS = tuple((2 * i - 23) * 200_000 for i in range(24))
W24_STEPS = 3
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNELS = {
    "K-FFT": ("radiocore_tpu_torch/csrc/fft_rows.cu",
              "radiocore_tpu/kernels/fft_pallas.py:258"),
    # K-FFT's row entries, held at row shapes; their launches are those
    # of the [routes] phase, whose routes put them on the system's paths.
    "K-FFT fft_pow2": ("radiocore_tpu_torch/csrc/fft_rows.cu",
                       "radiocore_tpu/kernels/fft_pallas.py:350"),
    "K-FFT ifft_pow2": ("radiocore_tpu_torch/csrc/fft_rows.cu",
                        "radiocore_tpu/kernels/fft_pallas.py:359"),
    "K-FFT rfft_pow2": ("radiocore_tpu_torch/csrc/fft_rows.cu",
                        "radiocore_tpu/kernels/fft_pallas.py:371"),
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
    # Replaces the reference's per-slice lowering, not a TPU kernel.
    "K-GATHER": ("radiocore_tpu_torch/csrc/extract_gather.cu",
                 "radiocore_tpu/ops/channelize.py:167"),
    # Replaces a lax.scan, not a TPU kernel.
    "K-NCO": ("radiocore_tpu_torch/csrc/nco_pll.cu",
              "radiocore_tpu/ops/nco_pll.py:53"),
    # Replaces jnp ops, not a TPU kernel.
    "K-QDEMOD": ("radiocore_tpu_torch/csrc/quad_demod.cu",
                 "radiocore_tpu/ops/demod.py:16"),
    # Replaces the library's transform (XLA's FFT in the reference), not
    # a TPU kernel.
    "K-BANDFFT": ("radiocore_tpu_torch/csrc/fft_band.cu",
                  "radiocore_tpu/ops/fft.py:306"),
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
    ref = torch.fft.fft(rows.to(torch.complex128))
    err = rel_l2(got, ref)
    ms = time_ms(lambda: fft_rows.fft_pow2(rows))
    plain = time_ms(lambda: fft_rows.fft_pow2_plain(rows))
    least = bound(16 * rows.numel(), fft_flops(STATION, N_STATIONS))
    report("K-FFT rows 64x2^18 fwd rel_l2", err, REL_L2_MAX, ms, plain,
           least, plain)
    out["K-FFT fft_pow2"] = dict(max_abs_err=max_abs(got, ref), ms=ms,
                                 plain_ms=plain, **least, library_ms=plain)
    del ref
    # The planar wrapper: the same DFT on (real, imag) float32 planes.
    xr, xi = rows.real.contiguous(), rows.imag.contiguous()
    got = torch.complex(*fft_rows.fft_pow2_planar(xr, xi))
    err = rel_l2(got, torch.fft.fft(rows.to(torch.complex128)))
    plain = time_ms(lambda: torch.fft.fft(torch.complex(xr, xi)))
    report("K-FFT planar 64x2^18 fwd rel_l2", err, REL_L2_MAX,
           time_ms(lambda: fft_rows.fft_pow2_planar(xr, xi)), plain,
           bound(16 * rows.numel(), fft_flops(STATION, N_STATIONS)), plain)
    del rows, got, xr, xi

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
    ref = torch.fft.rfft(real.double())
    err = rel_l2(got, ref)
    ms = time_ms(lambda: fft_rows.rfft_pow2(real))
    plain = time_ms(lambda: fft_rows.rfft_pow2_plain(real))
    least = bound(4 * real.numel() + 8 * got.numel(),
                  fft_flops(STATION // 2, N_STATIONS))
    report("K-FFT rfft 64x2^18 real rel_l2", err, REL_L2_MAX, ms, plain,
           least, plain)
    out["K-FFT rfft_pow2"] = dict(max_abs_err=max_abs(got, ref), ms=ms,
                                  plain_ms=plain, **least, library_ms=plain)
    del got, ref

    # The inverse wrappers, at the same row shapes.
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


def check_gather(device, gen) -> tuple:
    """K-GATHER at the wbfm24 plan: against its plain version in
    complex128; its device time and the torch reorder's (the ``native``
    route's gathers, window, fold, stack and divide), each call after a
    flush of the L2, beside the bound; the extraction stage (``auto``
    against ``native``) as CUDA graphs; and its launches a step of the
    ``off`` step in both modes, replayed. Returns its stats and its
    launches a ``fast`` step."""
    import torch
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.ops.channelize import (extraction_plan,
                                                    make_extractor)
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    from radiocore_tpu_torch.runtime import Routes
    n, m = W24_BAND, W24_STATION
    shifts = tuple(-o for o in W24_OFFSETS)
    c = len(shifts)
    spec = crandn(gen, device, n)
    auto = make_extractor(n, shifts, m)
    native = make_extractor(n, shifts, m, Routes(extract_ifft="native"))
    got = auto.gather(spec)
    starts, w_out, w_fix, _, _ = extraction_plan(n, shifts, m)
    ref = extract.extract_gather_plain(
        spec.to(torch.complex128),
        torch.tensor(starts, dtype=torch.int64, device=device),
        torch.from_numpy(w_out.astype("float64") / n).to(device),
        float(w_fix) / n)
    err, max_err = rel_l2(got, ref), max_abs(got, ref)
    reorder_err = rel_l2(native.reorder(spec), ref)
    del ref
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    flushing = {name for name, _ in kernel_times_ms(flush.zero_)}

    def device_ms(fn):
        times = kernel_times_ms(lambda: (flush.zero_(), fn()))
        return [(name, ms) for name, ms in times if name not in flushing]

    gather = device_ms(lambda: auto.gather(spec))
    ms = sum(t for name, t in gather if "gather_kernel" in name)
    if len(gather) != 1 or not ms:
        raise AssertionError(f"K-GATHER: kernels {gather}")
    reorder = device_ms(lambda: native.reorder(spec))
    reorder_ms = sum(t for _, t in reorder)
    plain = time_ms(lambda: extract.extract_gather_plain(
        spec, torch.tensor(starts, dtype=torch.int64, device=device),
        torch.from_numpy(w_out.astype("float64") / n).float().to(device),
        float(w_fix) / n))
    least = bound(16 * c * m, 0.0)
    report(f"K-GATHER {c}x{m} in {n} rel_l2", err, REL_L2_MAX, ms, plain,
           least)
    print(f"[kernel] K-GATHER against the torch reorder: {ms:.4f} ms "
          f"(1 kernel) against {reorder_ms:.4f} ms ({len(reorder)} "
          f"kernels), device time after an L2 flush; the torch reorder's "
          f"rel_l2 {reorder_err:.3e}")
    stage = {}
    for name, ext in (("auto", auto), ("native", native), ("auto2", auto),
                      ("native2", native)):
        stage[name] = time_min_median_ms(_graphed(lambda: ext(spec)))[1]
    print("[kernel] K-GATHER extraction stage as a CUDA graph (median of "
          "50): " + ", ".join(f"{k} {v:.4f} ms" for k, v in stage.items()))
    del flush, spec, got
    band = crandn(gen, device, n)
    per_step = {}
    for mode in ("fast", "exact"):
        step, state = make_multi_station_step(
            n, W24_OFFSETS, m, W24_AUDIO, mode=mode, device=device)
        step(band, state)
        torch.cuda.synchronize()
        before = extract.gather_launches.count, extract.launches.count
        for _ in range(W24_STEPS):
            _, state = step(band, state)
        torch.cuda.synchronize()
        per_step[mode] = (
            (extract.gather_launches.count - before[0]) / W24_STEPS,
            (extract.launches.count - before[1]) / W24_STEPS)
        del step, state
    print(f"[kernel] K-GATHER launches a step of the off step at the wbfm24 "
          f"plan (K-GATHER, K-EXTRACT): {per_step}")
    if any(v != (1.0, 0.0) for v in per_step.values()):
        raise AssertionError(f"K-GATHER: launches a step {per_step}")
    return (dict(max_abs_err=max_err, ms=ms, plain_ms=plain, **least,
                 library_ms=None, reorder_ms=reorder_ms, stage_ms=stage),
            int(per_step["fast"][0]))


def check_quad_demod(device, gen) -> dict:
    """K-QDEMOD at the wbfm24 cells' shape, 24 x 240 000, and at a mix
    group's 8 rows of it (rows 8:16, from a row offset): against its plain
    version (the torch chain it replaces on the card), the samples that
    differ and the largest gap; the device time of both after an L2 flush
    (the bound's case) and back to back (the IQ partly in the L2, as the
    extraction leaves it in a step), beside the bytes bound."""
    import torch
    from radiocore_tpu_torch.kernels import quad_demod as kq
    c, m = len(W24_OFFSETS), W24_STATION
    iq = fm_stations(gen, c, m, device).to(torch.complex64)
    iq += 0.01 * crandn(gen, device, c, m)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    flushing = {name for name, _ in kernel_times_ms(flush.zero_)}

    def device_ms(fn, flushed):
        times = kernel_times_ms((lambda: (flush.zero_(), fn())) if flushed
                                else fn)
        return sum(ms for name, ms in times if name not in flushing)

    stats = {}
    for what, rows in (("", slice(0, c)), ("_8rows", slice(8, 16))):
        x = iq[rows]
        shape = f"{x.shape[0]}x{m}"
        got, want = kq.quad_demod_rows(x), kq.quad_demod_plain(x)
        differ = int((got != want).sum())
        err = max_abs(got, want)
        kernel = [name for name, _ in kernel_times_ms(
            lambda: kq.quad_demod_rows(x))]
        if len(kernel) != 1 or "quad_demod_kernel" not in kernel[0]:
            raise AssertionError(f"K-QDEMOD: kernels {kernel}")
        chain = kernel_times_ms(lambda: kq.quad_demod_plain(x))
        ms = device_ms(lambda: kq.quad_demod_rows(x), True)
        plain = device_ms(lambda: kq.quad_demod_plain(x), True)
        warm = device_ms(lambda: kq.quad_demod_rows(x), False)
        plain_warm = device_ms(lambda: kq.quad_demod_plain(x), False)
        least = bound(12 * x.numel(), 0.0)
        report(f"K-QDEMOD {shape} max_abs against the torch chain "
               f"({differ} of {x.numel()} samples differ)", err,
               QDEMOD_ABS_MAX, ms, plain, least)
        print(f"[kernel] K-QDEMOD {shape} device time after an L2 flush: "
              f"kernel {ms:.4f} ms, torch chain {plain:.4f} ms "
              f"({len(chain)} kernels); back to back: kernel {warm:.4f} ms, chain "
              f"{plain_warm:.4f} ms; {kernel[0]}")
        stats.update({f"ms{what}": ms, f"plain_ms{what}": plain,
                      f"warm_ms{what}": warm, f"plain_warm_ms{what}":
                      plain_warm, f"max_abs_err{what}": err,
                      f"differing{what}": differ})
        if not what:
            stats.update(least)
    stats["library_ms"] = None
    return stats


def check_band_fft(device, gen) -> tuple:
    """K-BANDFFT at the 10 MS/s band, 1 x 10^7 and 2 x 10^7 points, and
    at 1 x 3200², the other size routed to it: its rel_l2 against cuFFT in
    complex128 beside cuFFT's own in complex64 (both signs; the kernels'
    no worse than twice cuFFT's), the input left as it was, the device
    time of its two kernels and of cuFFT after an L2 flush beside the
    bytes bound, each pass alone, and its launches a replayed step of the
    wbfm24 ``fast`` step (2). Returns its stats and those launches."""
    import torch
    from radiocore_tpu_torch.kernels import fft_band as fb
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    flushing = {name for name, _ in kernel_times_ms(flush.zero_)}

    def device_ms(fn):
        times = kernel_times_ms(lambda: (flush.zero_(), fn()))
        return [(name, ms) for name, ms in times if name not in flushing]

    stats = {}
    for rows, n, what in ((1, W24_BAND, ""), (2, W24_BAND, "_2rows"),
                          (1, 3200 * 3200, "_3200x3200")):
        a, b = fb.band_split(n)
        x = crandn(gen, device, rows, n)
        keep = x.clone()
        for sign in (-1.0, 1.0):
            x64 = x.to(torch.complex128)
            want = (torch.fft.fft(x64) if sign < 0 else
                    torch.fft.ifft(x64, norm="forward"))
            del x64
            err = rel_l2(fb.fft_band_rows(x, sign), want)
            lib = rel_l2(fb.fft_band_plain(x, sign), want)
            del want
            print(f"[kernel] K-BANDFFT {rows}x{n} sign {sign:+.0f}: rel_l2 "
                  f"{err:.3e}, cuFFT complex64 {lib:.3e}")
            if not err <= 2 * lib:
                raise AssertionError(f"K-BANDFFT: rel_l2 {err} above twice "
                                     f"cuFFT's {lib}")
            stats[f"rel_l2{what}_{sign:+.0f}"] = err
            stats[f"library_rel_l2{what}_{sign:+.0f}"] = lib
        if not torch.equal(x, keep):
            raise AssertionError("K-BANDFFT wrote its input")
        del keep
        kernels = device_ms(lambda: fb.fft_band_rows(x))
        names = [name for name, _ in kernels]
        if (len(kernels) != 2 or "band_pass_kernel" not in names[0]
                or "band_pass_kernel" not in names[1]):
            raise AssertionError(f"K-BANDFFT: kernels {kernels}")
        ms = sum(t for _, t in kernels)
        library = sum(t for _, t in device_ms(lambda: torch.fft.fft(x)))
        plain = time_ms(lambda: fb.fft_band_plain(x))
        least = bound(16 * rows * n, fft_flops(n, rows))
        report(f"K-BANDFFT {rows}x{n} ({a}x{b}, chains {fb.CHAINS[a]} and "
               f"{fb.CHAINS[b]}) rel_l2", stats[f"rel_l2{what}_-1"],
               2 * stats[f"library_rel_l2{what}_-1"], ms, plain, least,
               library)
        print(f"[kernel] K-BANDFFT {rows}x{n} device time after an L2 "
              f"flush: column pass {kernels[0][1]:.4f} ms, row pass "
              f"{kernels[1][1]:.4f} ms, both {ms:.4f} ms; cuFFT "
              f"{library:.4f} ms; bytes bound {least['bound_ms']:.4f} ms")
        stats.update({f"ms{what}": ms, f"library_ms{what}": library,
                      f"column_ms{what}": kernels[0][1],
                      f"row_ms{what}": kernels[1][1]})
        if not what:
            stats.update(plain_ms=plain, **least)
        del x
    del flush
    torch.cuda.empty_cache()
    step, state = make_multi_station_step(
        W24_BAND, W24_OFFSETS, W24_STATION, W24_AUDIO, mode="fast", device=device)
    band = crandn(gen, device, W24_BAND) * 0.01
    for _ in range(2):
        _, state = step(band, state)
    torch.cuda.synchronize()
    before = fb.launches.count
    for _ in range(W24_STEPS):
        _, state = step(band, state)
    torch.cuda.synchronize()
    per_step = (fb.launches.count - before) / W24_STEPS
    print(f"[kernel] K-BANDFFT launches a replayed step of the wbfm24 fast "
          f"step: {per_step}")
    if per_step != 2:
        raise AssertionError(f"K-BANDFFT: {per_step} launches a step")
    return stats, int(per_step)


# The mixed24 cell (portbench/configs/mixed24.json): the wbfm24 plan with
# WBFM, MFM and FM stations in rotation, the server's own mix, on the band
# of the resident traffic (portbench/signals.band_pool).
MIXED_SEED = (1 << 31) + 2525
MIXED_STEPS = 3
# K-FIR launches a mixed step: the exact WBFM group's three (as the exact
# step's, phase 10) and the MFM group's de-emphasis.
MIXED_FIR = 4


def check_mixed(device, gen) -> None:
    """The mixed24 cell's step, ``make_multi_station_step(kinds=...)`` at
    24 x 240 000 on the resident band, on the card: ``step.rows``; the
    launches of one replayed step (K-GATHER 1, K-EXTRACT 0, K-FIR
    ``MIXED_FIR``, K-QDEMOD one a group, each kind's
    ``pipeline.demodulated`` its rows), the
    same times ``MIXED_STEPS`` over as many replays, and one graph;
    K-GATHER on the permuted plan (rows WBFM, MFM, FM) against its plain
    version in complex128, and the step's extraction against the
    station-order extraction with its rows permuted; K-FIR at the MFM
    group's shape against float64; two chained chunks, audio and every
    carried history, against the same step on the CPU."""
    import json
    import torch
    from portbench import signals
    from radiocore_tpu_torch.kernels import extract, fir, quad_demod
    from radiocore_tpu_torch.ops.channelize import (extraction_plan,
                                                    make_extractor)
    from radiocore_tpu_torch.ops.design import deemphasis_taps
    from radiocore_tpu_torch.parallel import pipeline

    with open(REPO / "portbench/configs/mixed24.json") as f:
        config = json.load(f)
    with open(REPO / "portbench/traffic/resident_mixed.json") as f:
        traffic = json.load(f)
    n, m, ac = (int(config[k])
                for k in ("band_rate", "station_rate", "audio_rate"))
    offs, kinds = signals.offsets(config), config["kinds"]
    if (n, m, ac, tuple(offs)) != (W24_BAND, W24_STATION, W24_AUDIO,
                                   W24_OFFSETS):
        raise AssertionError("mixed24 is not the wbfm24 plan")
    pool = signals.band_pool(MIXED_SEED, config, traffic, device)

    def build(where):
        return pipeline.make_multi_station_step(
            n, offs, m, ac, config["deemphasis_s"], mode=config["mode"],
            kinds=kinds, device=where)

    step, state0 = build(device)
    want_rows = {kind: tuple(i for i, k in enumerate(kinds) if k == kind)
                 for kind in pipeline.KINDS}
    if step.rows != want_rows:
        raise AssertionError(f"mixed step rows {step.rows}")
    perm = [i for r in step.rows.values() for i in r]

    counters = {"K-GATHER": extract.gather_launches,
                "K-EXTRACT": extract.launches, "K-FIR": fir.launches,
                "K-QDEMOD": quad_demod.launches,
                **{f"demodulated[{kind}]": pipeline.demodulated[kind]
                   for kind in step.rows}}
    want = {"K-GATHER": 1, "K-EXTRACT": 0, "K-FIR": MIXED_FIR,
            "K-QDEMOD": len(step.rows),
            **{f"demodulated[{kind}]": len(r)
               for kind, r in step.rows.items()}}
    chained = [step(pool[0], state0)]        # the capture
    torch.cuda.synchronize()
    for ctr in counters.values():
        ctr.reset()
    chained.append(step(pool[1], chained[0][1]))
    torch.cuda.synchronize()
    one = {name: ctr.count for name, ctr in counters.items()}
    state = chained[1][1]
    for ctr in counters.values():
        ctr.reset()
    for k in range(MIXED_STEPS):
        _, state = step(pool[2 + k % 2], state)
    torch.cuda.synchronize()
    many = {name: ctr.count for name, ctr in counters.items()}
    print(f"[mixed] {len(kinds)} x {m} -> {ac}, kinds {kinds[:3]} in "
          f"rotation, rows {dict((k, len(r)) for k, r in step.rows.items())}"
          f": launches of one replayed step {one}; over {MIXED_STEPS} "
          f"replays {many}; graphs {step.graph_count}")
    if one != want:
        raise AssertionError(f"mixed step launches {one}, want {want}")
    if many != {name: MIXED_STEPS * v for name, v in want.items()}:
        raise AssertionError(f"mixed step launches over {MIXED_STEPS} "
                             f"replays {many}")
    if step.graph_count != 1:
        raise AssertionError(f"mixed step graphs {step.graph_count}")
    print(f"[mixed] {step_ms(step, pool[0], state)}; stages (median of 20) "
          + ", ".join(f"{k} {v:.3f} ms"
                      for k, v in stage_ms(step, pool[0], state).items()))

    # K-GATHER on the permuted plan, and the step's own extraction.
    spec = step.stages["band_fft"](pool[0])
    shifts = tuple(-offs[i] for i in perm)
    auto = make_extractor(n, shifts, m)
    got = auto.gather(spec)
    starts, w_out, w_fix, _, _ = extraction_plan(n, shifts, m)
    args = (torch.tensor(starts, dtype=torch.int64, device=device),
            torch.from_numpy(w_out.astype("float64") / n).to(device),
            float(w_fix) / n)
    ref = extract.extract_gather_plain(spec.to(torch.complex128), *args)
    err = rel_l2(got, ref)
    del ref
    gather = [(name, ms) for name, ms in kernel_times_ms(
        lambda: auto.gather(spec)) if "gather_kernel" in name]
    plain = time_ms(lambda: extract.extract_gather_plain(
        spec, args[0], args[1].float(), args[2]))
    report(f"K-GATHER {len(shifts)}x{m} in {n}, rows WBFM, MFM, FM rel_l2",
           err, REL_L2_MAX, sum(ms for _, ms in gather), plain,
           bound(16 * len(shifts) * m, 0.0))
    extract.gather_launches.reset()
    mixed_iq = step.stages["extract"](spec)
    torch.cuda.synchronize()
    launched = extract.gather_launches.count
    station_iq = make_extractor(n, tuple(-o for o in offs), m)(spec)[perm]
    iq_err = rel_l2(mixed_iq, station_iq)
    print(f"[mixed] the step's extraction against the station-order one, "
          f"rows permuted: rel_l2 {iq_err:.3e} (bound {REL_L2_MAX:.0e}), "
          f"bit for bit {bool(torch.equal(mixed_iq, station_iq))}; K-GATHER "
          f"launches {launched}")
    if not iq_err <= REL_L2_MAX or launched != 1:
        raise AssertionError(f"mixed extraction: rel_l2 {iq_err}, K-GATHER "
                             f"launches {launched}")
    del spec, got, mixed_iq, station_iq

    # K-FIR at the MFM group's shape: its rows, the audio chunk, 51 taps.
    taps = deemphasis_taps(ac, config["deemphasis_s"])
    x, hist = fir_case(device, gen, len(step.rows["mfm"]), ac, taps)
    got = fir.fir_causal_rows(x, taps, hist)
    ref = fir.fir_causal_plain(x.double(), taps, hist.double())
    report(f"K-FIR {len(taps)} taps {x.shape[0]}x{ac} (the MFM group) "
           f"max_abs", max_abs(got, ref), FIR_ABS_MAX,
           fir_device_ms(lambda: fir.fir_causal_rows(x, taps, hist)),
           time_ms(lambda: fir.fir_causal_plain(x, taps, hist)),
           bound(4 * (x.numel() + hist.numel() + got.numel()),
                 2.0 * len(taps) * x.numel()))
    del x, hist, got, ref

    # Two chained chunks against the same step on the CPU.
    step_cpu, state_cpu = build("cpu")
    gaps = []
    for k, (audio, state) in enumerate(chained):
        audio_cpu, state_cpu = step_cpu(pool[k].cpu(), state_cpu)
        for kind, a in audio.items():
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"mixed: non-finite {kind} audio")
        leaves = [(f"audio {kind}", audio[kind], audio_cpu[kind])
                  for kind in audio_cpu]
        leaves += [(f"{kind} {key}", state[kind][key], v)
                   for kind, sub in state_cpu.items()
                   for key, v in sub.items()]
        gaps.append({what: max_abs(a.cpu(), b) for what, a, b in leaves})
    worst = max(max(g.values()) for g in gaps)
    print(f"[mixed] chunks 1-2 chained, card vs CPU max_abs: " + "; ".join(
        f"chunk {k + 1} " + ", ".join(f"{w} {v:.2e}" for w, v in g.items())
        for k, g in enumerate(gaps)) + f" (bound {E2E_ABS_MAX:.0e})")
    if not worst <= E2E_ABS_MAX:
        raise AssertionError(f"mixed: card and CPU differ by {worst}")


# The wbfm48_2band cell (portbench/configs/wbfm48_2band.json): two bands of
# the wbfm24 plan's rate and widths, band B's plan band A's moved down
# 100 kHz, on the pools of the resident_bands traffic.
BANDS_SEED = (1 << 31) + 2828
BANDS_STEPS = 3


def check_bands(device, gen) -> None:
    """The wbfm48_2band cell's step, ``make_multi_station_step(bands=...)``
    at 2 x 24 x 240 000 on the resident_bands pools, on the card:
    ``step.band_rows``; the launches of one replayed step (K-GATHER 1,
    K-EXTRACT 0, K-QDEMOD 1, K-FIR 1, ``pipeline.bands`` 2), the same
    times ``BANDS_STEPS`` over as many replays, and one graph; the step
    and each stage alone; K-GATHER with both plans against its plain
    version in complex128, and each band's rows against the one-plan
    gather of that band; two chained chunks, audio and every carried
    history, against the same step on the CPU."""
    import json
    import torch
    from portbench import bands
    from radiocore_tpu_torch.kernels import extract, fir, quad_demod
    from radiocore_tpu_torch.ops.channelize import make_band_extractor
    from radiocore_tpu_torch.parallel import pipeline

    del gen
    with open(REPO / "portbench/configs/wbfm48_2band.json") as f:
        config = json.load(f)
    with open(REPO / "portbench/traffic/resident_bands.json") as f:
        traffic = json.load(f)
    n, m, ac = (int(config[k])
                for k in ("band_rate", "station_rate", "audio_rate"))
    plans = bands.band_offsets(config)
    if (n, m, ac, tuple(plans[0])) != (W24_BAND, W24_STATION, W24_AUDIO,
                                       W24_OFFSETS):
        raise AssertionError("wbfm48_2band's band A is not the wbfm24 plan")
    pool = bands.band_pools(BANDS_SEED, config, traffic, device)

    def build(where):
        return pipeline.make_multi_station_step(
            n, None, m, ac, config["deemphasis_s"], mode=config["mode"],
            bands=plans, device=where)

    step, state0 = build(device)
    if step.band_rows != (range(0, 24), range(24, 48)):
        raise AssertionError(f"bands step rows {step.band_rows}")
    counters = {"K-GATHER": extract.gather_launches,
                "K-EXTRACT": extract.launches, "K-FIR": fir.launches,
                "K-QDEMOD": quad_demod.launches,
                "pipeline.bands": pipeline.bands}
    want = {"K-GATHER": 1, "K-EXTRACT": 0, "K-FIR": 1, "K-QDEMOD": 1,
            "pipeline.bands": 2}
    chained = [step(pool[0], state0)]        # the capture
    torch.cuda.synchronize()
    for ctr in counters.values():
        ctr.reset()
    chained.append(step(pool[1], chained[0][1]))
    torch.cuda.synchronize()
    one = {name: ctr.count for name, ctr in counters.items()}
    state = chained[1][1]
    for ctr in counters.values():
        ctr.reset()
    for k in range(BANDS_STEPS):
        _, state = step(pool[2 + k % 2], state)
    torch.cuda.synchronize()
    many = {name: ctr.count for name, ctr in counters.items()}
    print(f"[bands] {len(plans)} bands x {len(plans[0])} x {m} -> {ac}, "
          f"band B's plan band A's moved {plans[1][0] - plans[0][0]} Hz: "
          f"launches of one replayed step {one}; over {BANDS_STEPS} "
          f"replays {many}; graphs {step.graph_count}")
    if one != want:
        raise AssertionError(f"bands step launches {one}, want {want}")
    if many != {name: BANDS_STEPS * v for name, v in want.items()}:
        raise AssertionError(f"bands step launches over {BANDS_STEPS} "
                             f"replays {many}")
    if step.graph_count != 1:
        raise AssertionError(f"bands step graphs {step.graph_count}")
    print(f"[bands] {step_ms(step, pool[0], state)}; stages alone "
          f"(median of 20) "
          + ", ".join(f"{k} {v:.3f} ms"
                      for k, v in stage_ms(step, pool[0], state).items()))

    # K-GATHER with both plans against complex128 and the one-plan gather.
    spectra = step.stages["band_fft"](pool[0])
    ex = make_band_extractor(n, [[-o for o in p] for p in plans], m)
    got = ex.gather(spectra)
    _, window, fix = ex.by_band[0].gather_plan
    at = torch.tensor([b * n + a for b, e in enumerate(ex.by_band)
                       for a in e.gather_plan[0]], device=device)
    ref = extract.extract_gather_rows_plain(
        spectra.to(torch.complex128), at, window.on(device).double(), fix)
    err = rel_l2(got, ref)
    del ref
    gather = [(name, ms) for name, ms in kernel_times_ms(
        lambda: ex.gather(spectra)) if "gather_kernel" in name]
    plain = time_ms(lambda: extract.extract_gather_rows_plain(
        spectra, at, window.on(device), fix))
    report(f"K-GATHER two plans {at.numel()}x{m} in 2x{n} rel_l2", err,
           REL_L2_MAX, sum(ms for _, ms in gather), plain,
           bound(16 * at.numel() * m, 0.0))
    alone = [bool(torch.equal(got[24 * b:24 * (b + 1)],
                              e.gather(spectra[b])))
             for b, e in enumerate(ex.by_band)]
    print(f"[bands] each band's rows against the one-plan gather of that "
          f"band alone, bit for bit: {alone}")
    if not all(alone):
        raise AssertionError(f"bands gather against the one-plan: {alone}")
    del spectra, got

    # Two chained chunks against the same step on the CPU.
    step_cpu, state_cpu = build("cpu")
    gaps = []
    for k, (audio, state) in enumerate(chained):
        audio_cpu, state_cpu = step_cpu(pool[k].cpu(), state_cpu)
        if not bool(torch.isfinite(audio).all()):
            raise AssertionError("bands: non-finite audio")
        leaves = [("audio", audio, audio_cpu)] + [
            (key, state[key], v) for key, v in state_cpu.items()]
        gaps.append({what: max_abs(a.cpu(), b) for what, a, b in leaves})
    worst = max(max(g.values()) for g in gaps)
    print(f"[bands] chunks 1-2 chained, card vs CPU max_abs: " + "; ".join(
        f"chunk {k + 1} " + ", ".join(f"{w} {v:.2e}" for w, v in g.items())
        for k, g in enumerate(gaps)) + f" (bound {E2E_ABS_MAX:.0e})")
    if not worst <= E2E_ABS_MAX:
        raise AssertionError(f"bands: card and CPU differ by {worst}")


def _graphed(fn):
    """``fn`` captured once as a CUDA graph (after three warm-up calls
    on a side stream); the graph's replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


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
    import importlib.util
    from radiocore_tpu_torch.kernels import (extract, extract_demod as xd,
                                             fft_mixed, fft_rows, fir)
    band = {"K-FFT": fft_rows.launches} if c * STATION == N_BAND else {
        "K-MIXED": fft_mixed.launches}
    # ``--paths`` also drives trees from before K-QDEMOD.
    demod = {}
    if importlib.util.find_spec("radiocore_tpu_torch.kernels.quad_demod"):
        from radiocore_tpu_torch.kernels import quad_demod
        demod = {"K-QDEMOD": quad_demod.launches}
    if mode == "exact":
        return {**band, "K-EXTRACT": extract.launches, **demod,
                "K-FIR": fir.launches}
    rfft = {"K-FFT": fft_rows.launches}
    middle = {"off": {"K-EXTRACT": extract.launches, **demod, **rfft},
              "fused": {"K-XDEMOD": xd.launches, **rfft},
              "spec": {"K-XDEMOD-SPEC": xd.spec_launches}}[extract_demod]
    return {**band, **middle, "K-FIR": fir.launches}


def run_main_path(device, gen, c=N_STATIONS, sc=STATION, ac=AUDIO,
                  chunks=CHUNKS, extract_demod="off", mode="fast",
                  routes=None, bands=None, also=None):
    """Drive a path over chained chunks: ``bands``, or ``chunks`` seeded
    ones. Returns the step, its state, the bands, their audio and the
    launch counts of the kernels the path must go through and of ``also``
    (name -> counter), every count set to 0 just before the run. On the
    default routes (``routes`` None) each of the path's kernels must
    launch; under ``routes`` the caller checks the counts."""
    import torch
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step

    # No routes= on the default routes: ``--paths`` drives checkouts from
    # before the routes too.
    kw = {} if routes is None else {"routes": routes}
    step, state = make_multi_station_step(c * sc, offsets(c, sc), sc, ac,
                                          mode=mode,
                                          extract_demod=extract_demod,
                                          device=device, **kw)
    if bands is None:
        bands = [fm_band(gen, c, sc, device) for _ in range(chunks)]
    counters = {**path_counters(c, extract_demod, mode), **(also or {})}
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
    for name in path_counters(c, extract_demod, mode):
        if routes is None and launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the mode="
                                 f"{mode!r}, extract_demod="
                                 f"{extract_demod!r} path")
    return step, state, bands, audios, launches


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
    kind = "graph replays" if hasattr(step, "eager") else "eager steps"
    print(f"[{what}] profile of {kind}, per step of {steps}: span "
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


def pilots(gen, rows: int, n: int, device, rate: int = STATION):
    """``rows`` rms-normalised 19 kHz pilots of ``n`` samples at ``rate``
    samples a second, float32: each with its own frequency offset (within
    +-3 Hz) and start phase, plus noise at 0.1 of the rms."""
    import torch
    f64 = dict(dtype=torch.float64, device=device)
    t = torch.arange(n, **f64) / rate
    f = 19e3 + 6.0 * (torch.rand(rows, 1, generator=gen, **f64) - 0.5)
    phi = 2 * math.pi * torch.rand(rows, 1, generator=gen, **f64)
    x = math.sqrt(2.0) * torch.sin(2 * math.pi * f * t + phi)
    x += 0.1 * torch.randn(rows, n, generator=gen, **f64)
    return x.float()


def nco_model(pilot, gains, phase, freq, dtype):
    """The loop in the scan's order in NumPy, rows as the vector, every
    operation in ``dtype`` (float64: the reference; float32: the scan as
    the JAX package runs it): ``(traj, phase, freq)``."""
    import numpy as np
    kp, ki, w0 = (dtype(g) for g in gains)
    pi, two_pi = dtype(np.pi), dtype(2 * np.pi)
    x = np.asarray(pilot, dtype)
    phase = np.array(phase, dtype)
    freq = np.array(freq, dtype)
    traj = np.empty_like(x)
    for t in range(x.shape[-1]):
        err = x[:, t] * np.cos(phase)
        traj[:, t] = phase
        freq = freq + ki * err
        phase = phase + w0 + freq + kp * err
        phase = np.where(phase > pi, phase - two_pi, phase)
    return traj, phase, freq


def nco_sass_summary(lib_path) -> str:
    """K-NCO's instantiations in the built library (``cuobjdump -sass``):
    for each, the opcodes that show its chain and its guard (the
    special-function unit's, MUFU; the fused multiply-adds; the branches
    and calls; the selects), the same in its largest straight-line block
    (between labels and branches; the tile's samples unrolled, where the
    subcarrier's has no MUFU), and the md5 of its instruction text (each
    line's whitespace collapsed), which two builds share when their code
    for it is the same."""
    import hashlib
    import re
    tool = Path(build_tool("cuobjdump"))
    out = subprocess.run([str(tool), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    parts = re.split(r"\n\s*Function : ", out)
    op_re = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)")
    kinds = ("MUFU", "MUFU.COS", "FFMA", "FSEL", "BRA", "CALL")
    lines = []
    for part in parts[1:]:
        name = part.split("\n", 1)[0].strip()
        if "nco_pll_kernel" not in name:
            continue
        ops, blocks, block, text = [], [], [], []
        for line in part.splitlines()[1:]:
            if "/*" in line:
                # The columns' widths follow the longest name in the file.
                text.append(" ".join(line.split()))
            if re.match(r"\s*\.L_x_\d+:", line):
                blocks.append(block)
                block = []
                continue
            m = op_re.search(line)
            if m is None:
                continue
            ops.append(m.group(1))
            block.append(m.group(1))
            if m.group(1).startswith(("BRA", "EXIT", "RET", "CALL", "BRX")):
                blocks.append(block)
                block = []
        blocks.append(block)
        big = max(blocks, key=len)

        def count(seq):
            return ", ".join(f"{k} {sum(1 for o in seq if o.startswith(k))}"
                             for k in kinds)
        kernel = re.search(r"nco_pll_kernel[a-z_]*", name).group(0)
        args = ", ".join("true" if t == "b" and v == "1" else
                         "false" if t == "b" else v
                         for t, v in re.findall(r"L([bi])(\d+)E", name))
        md5 = hashlib.md5("\n".join(text).encode()).hexdigest()
        lines.append(f"{kernel}<{args}>: md5 {md5}, {len(ops)} "
                     f"instructions, {count(ops)}; largest straight-line "
                     f"block {len(big)} instructions, {count(big)}")
    if not lines:
        raise AssertionError("cuobjdump shows no nco_pll_kernel")
    return "; ".join(lines)


def build_tool(name: str) -> str:
    """A tool of the CUDA toolkit that holds nvcc."""
    from radiocore_tpu_torch.kernels import build
    return str(Path(build.find_nvcc()).parent / name)


def sm_clock_mhz():
    """The SM clock ``nvidia-smi`` reports right now, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def check_nco(device, gen) -> dict:
    """Phase 8: K-NCO. Its phase output (``nco_pll_track_rows``) against
    its plain loop at a short length (aligned rows and rows off a 16-byte
    boundary, each with a NaN row and a row started 8 turns away), the
    float32 scan's distance printed beside it; at the nco path's shape
    against a float64 model of the loop beside the float32 scan's own
    distance; the phase output's time there and at the wbfm24 cells'
    shape; the probe's chains; then the subcarrier output
    (:func:`check_nco_phasor`), whose entry it returns."""
    import numpy as np
    import torch
    from radiocore_tpu_torch.kernels import build, nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import pll_design

    print(f"[kernel] K-NCO SASS: {nco_sass_summary(build.build().path)}")
    gains = pll_design(STATION, 19e3, 50.0)
    rows, n = NCO_SHORT
    wide = pilots(gen, rows, n + 8, device)
    wide[NCO_DEAD] = float("nan")
    live = [r for r in range(rows) if r != NCO_DEAD]
    for what, x, turns in ((f"{rows}x{n}", wide[:, :n].contiguous(), -8),
                           (f"{rows}x{n + 1} rows off a 16-byte boundary",
                            wide[:, 1:n + 2], 8)):
        phase0 = 2.0 * torch.rand(rows, generator=gen, device=device) - 1.0
        phase0[NCO_WILD] += turns * 2 * math.pi
        freq0 = 1e-5 * torch.randn(rows, generator=gen, device=device)
        got = [v.cpu() for v in knco.nco_pll_track_rows(x, *gains, phase0,
                                                        freq0)]
        held = (x.cpu(), *gains, phase0.cpu(), freq0.cpu())
        ref = knco.nco_pll_phasor_plain(held[0], torch.ones(rows),
                                        *held[1:], "phase")
        scan = knco.nco_pll_track_plain(*held)
        errs = (float(wrapped(got[0][live], ref[0][live]).abs().max()),
                float(wrapped(got[1][live], ref[1][live]).abs().max()),
                max_abs(got[2][live], ref[2][live]))
        dead = [bool(v[NCO_DEAD, 1:].isnan().all()) and
                bool(v[NCO_DEAD, 0] == held[4][NCO_DEAD]) and
                bool(p[NCO_DEAD].isnan()) and bool(f[NCO_DEAD].isnan())
                for v, p, f in (got, ref)]
        wild = float(wrapped(got[0][NCO_WILD], ref[0][NCO_WILD]).abs().max())
        scan_err = float(wrapped(got[0][live], scan[0][live]).abs().max())
        print(f"[kernel] K-NCO phase {what} against its plain loop: "
              f"trajectory {errs[0]:.3e} rad, final phase {errs[1]:.3e} rad "
              f"(bound {NCO_PLAIN_MAX:.0e}, modulo 2 pi), final freq "
              f"{errs[2]:.3e} (bound 1e-7); row {NCO_WILD} started at "
              f"{float(phase0[NCO_WILD]):+.2f} rad: {wild:.3e} rad; NaN row "
              f"{NCO_DEAD} NaN in kernel and loop: {dead}; the float32 scan "
              f"(nco_pll_track_plain) {scan_err:.3e} rad from the kernel")
        if not (max(errs[:2]) <= NCO_PLAIN_MAX and errs[2] <= 1e-7
                and all(dead)):
            raise AssertionError(f"K-NCO phase {what} differs from its "
                                 f"plain loop: {errs}, NaN row {dead}")
    del wide

    # The nco path's shape: 64 stations, one second.
    rows, n = N_STATIONS, STATION
    x = pilots(gen, rows, n, device)
    zeros = torch.zeros(rows, device=device)
    traj, phase, freq = knco.nco_pll_track_rows(x, *gains, zeros, zeros)
    torch.cuda.synchronize()
    held = [0, rows // 2, rows - 1]
    x_held = x[held].cpu().numpy()
    t0 = time.perf_counter()
    ref = nco_model(x_held, gains, np.zeros(len(held)), np.zeros(len(held)),
                    np.float64)
    scan = nco_model(x_held, gains, np.zeros(len(held)), np.zeros(len(held)),
                     np.float32)
    model_s = time.perf_counter() - t0

    def dist(run):
        return (float(wrapped(torch.as_tensor(run[0]),
                              torch.from_numpy(ref[0])).abs().max()),
                float(wrapped(torch.as_tensor(run[1]),
                              torch.from_numpy(ref[1])).abs().max()),
                float((torch.as_tensor(run[2]).double()
                       - torch.from_numpy(ref[2])).abs().max()))

    err, err_p, err_f = dist((traj[held].cpu(), phase[held].cpu(),
                              freq[held].cpu()))
    scan_err = dist(scan)
    # Locked: the integrator holds each row's frequency offset.
    hz = freq.double() * STATION / (2 * math.pi)
    print(f"[kernel] K-NCO phase {rows}x{n} against the float64 model (rows "
          f"{held}, {model_s:.1f} s on the host): trajectory {err:.3e} rad, "
          f"final phase {err_p:.3e} rad (bound {NCO_F64_MAX:.0e}, modulo "
          f"2 pi), final freq {err_f:.3e} (bound 1e-6); the float32 scan "
          f"(NumPy) on the same rows: trajectory {scan_err[0]:.3e} rad, "
          f"final phase {scan_err[1]:.3e} rad, final freq "
          f"{scan_err[2]:.3e}; tracked offsets {float(hz.min()):+.2f} .. "
          f"{float(hz.max()):+.2f} Hz")
    if not (max(err, err_p) <= NCO_F64_MAX and err_f <= 1e-6):
        raise AssertionError(f"K-NCO against float64: {err}, {err_p}, "
                             f"{err_f}")
    if not float(hz.abs().max()) < 4.0:
        raise AssertionError(f"K-NCO did not lock: offsets {hz}")

    # The phase output's time (no path runs it) at the nco path's shape
    # and at the wbfm24 cells'.
    times = []
    for shape, xs in ((f"{rows}x{n}", x),
                      (f"{len(W24_OFFSETS)}x{W24_STATION}",
                       pilots(gen, len(W24_OFFSETS), W24_STATION, device))):
        z = torch.zeros(xs.shape[0], device=device)

        def run(xs=xs, z=z):
            return knco.nco_pll_track_rows(xs, *gains, z, z)
        (_, device_ms), = [(k, t) for k, t in kernel_times_ms(run, reps=3)
                           if "nco_pll_kernel" in k]
        times.append(f"{shape} {time_ms(run, reps=5, warmup=1):.3f} ms "
                     f"between CUDA events, {device_ms:.3f} ms device time")
    # The SM clock while the kernel runs: some launches in flight.
    for _ in range(8):
        knco.nco_pll_track_rows(x, *gains, zeros, zeros)
    mhz = sm_clock_mhz()
    torch.cuda.synchronize()
    # The latency bound: each chain over a row of n links, one lane and a
    # whole warp, timed by CUDA events and counted in SM cycles.
    probe = {}
    for chain in knco.PROBE_CHAINS:
        for lanes in (1, 32):
            def run_probe(chain=chain, lanes=lanes):
                return knco.nco_chain_probe(n, chain, lanes, *gains)
            probe_ms = time_ms(run_probe, reps=3, warmup=1)
            _, cycles = run_probe()
            links = n - n % knco.PHASOR_TILE if chain != "phasor" else n
            probe[chain, lanes] = (probe_ms,
                                   float(cycles.double().max()) / links)
    # The chain lane beside three busy warps: on schedulers of their own,
    # they leave its cycles as they were.
    _, cycles = knco.nco_chain_probe(n, "chain_lane", 1, *gains,
                                     helpers=knco.HELPERS)
    busy = float(cycles.double().max()) / (n - n % knco.PHASOR_TILE)
    print(f"[kernel] K-NCO phase output: " + "; ".join(times))
    print(f"[kernel] K-NCO chain probe over {n} links: " + "; ".join(
        f"{chain} x{lanes} lanes {pms:.3f} ms, {cyc:.1f} cycles a link"
        for (chain, lanes), (pms, cyc) in probe.items())
        + f"; chain_lane x1 lane beside 3 busy warps {busy:.1f} cycles a "
        f"link")
    return dict(**check_nco_phasor(rows, n, gains, gen, probe, mhz),
                library_ms=None)


def check_nco_phasor(rows, n, gains, gen, probe, mhz) -> dict:
    """Phase 8, the subcarrier output: ``nco_pll_subcarrier_rows`` against
    ``nco_pll_subcarrier_plain`` on the same pilots at the nco path's
    shape ``rows`` x ``n``, two chunks as the step runs them: the first
    acquiring from a random phase, the second from the state the kernel
    carried; then on rows of the second off a 16-byte boundary at an odd
    length, and at a loop of ``NCO_WIDE_HZ`` whose tiles the guard
    redoes, the tiles each redid counted alike; then at the wbfm24 cells'
    shape, acquiring from phase 0. Its time on the second chunk beside its
    bytes bound and its latency bound (the phasor chain over a row, from
    ``probe``), and at the wbfm24 shape. Returns the kernel's entry."""
    import numpy as np
    import torch
    from radiocore_tpu_torch.kernels import nco_pll as knco
    from radiocore_tpu_torch.ops.nco_pll import pll_design

    card = gen.device
    chunks = pilots(gen, rows, 2 * n, card).reshape(rows, 2, n).unbind(1)

    def scale(x):
        rms = torch.sqrt(torch.mean(x * x, dim=-1))
        return torch.reciprocal(torch.clamp_min(
            rms, torch.finfo(torch.float32).tiny))

    def against_plain(what, x, g, phase, freq, held_from=0):
        """The kernel and the plain loop on ``x``, held from sample
        ``held_from`` on; the kernel's result."""
        r = x.shape[0]
        args = (scale(x), *g, phase, freq)
        before = (knco.redone.read(card), knco.redone.read("cpu"))
        got = knco.nco_pll_subcarrier_rows(x, *args)
        t0 = time.perf_counter()
        ref = knco.nco_pll_subcarrier_plain(x.cpu(), *(
            a.cpu() if torch.is_tensor(a) else a for a in args))
        plain_s[0] += time.perf_counter() - t0
        redid = (knco.redone.read(card) - before[0],
                 knco.redone.read("cpu") - before[1])
        d = (got[0].cpu() - ref[0]).abs()
        err = (float(d[:, held_from:].max()),
               float(wrapped(got[1].cpu(), ref[1]).abs().max()),
               max_abs(got[2].cpu(), ref[2]))
        held = ""
        if held_from:
            # Before it, the row the two loops part most, each against the
            # float64 loop (nco_model) on the same samples.
            r0 = int(d[:, :held_from].amax(1).argmax())
            traj = nco_model(
                (x[r0, :held_from].double() * args[0][r0].double())
                .cpu().numpy()[None], g, phase[r0:r0 + 1].cpu().numpy(),
                freq[r0:r0 + 1].cpu().numpy(), np.float64)[0]
            sub64 = torch.from_numpy(-np.sin(2 * traj[0]))
            held = (f"from sample {held_from} on (before it: "
                    f"{float(d[:, :held_from].max()):.3e}; on row {r0} the "
                    f"kernel {max_abs(got[0][r0, :held_from].cpu(), sub64):.3e}"
                    f" and the plain loop "
                    f"{max_abs(ref[0][r0, :held_from], sub64):.3e} from the "
                    f"float64 loop) ")
        print(f"[kernel] K-NCO subcarrier {what} against its plain loop: "
              f"subcarrier {held}{err[0]:.3e} (bound {NCO_SUB_MAX:.0e}), "
              f"final phase {err[1]:.3e} rad (bound {NCO_PLAIN_MAX:.0e}, "
              f"modulo 2 pi), final freq {err[2]:.3e} (bound 1e-7); tiles "
              f"redone by the kernel {redid[0]}, by the plain loop "
              f"{redid[1]}")
        if not (err[0] <= NCO_SUB_MAX and err[1] <= NCO_PLAIN_MAX
                and err[2] <= 1e-7 and redid[0] == redid[1]
                and (redid[0] > 0) == (g is wide)):
            raise AssertionError(f"K-NCO subcarrier {what} differs from "
                                 f"its plain loop: {err}, redone {redid}")
        errs.append(err[0])
        return got

    errs, plain_s = [], [0.0]
    wide = pll_design(STATION, 19e3, NCO_WIDE_HZ)
    phase0 = 2.0 * torch.rand(rows, generator=gen, device=card) - 1.0
    freq0 = 1e-5 * torch.randn(rows, generator=gen, device=card)
    _, phase, freq = against_plain(
        f"{rows}x{n} acquiring from a random phase", chunks[0], gains,
        phase0, freq0, held_from=NCO_ACQUIRE)
    x = chunks[1]
    against_plain(f"{rows}x{n} from the carried state", x, gains, phase,
                  freq)
    against_plain(f"{rows}x{NCO_OFF_N} rows off a 16-byte boundary",
                  x[:, 1:1 + NCO_OFF_N], gains, phase, freq)
    against_plain(f"4x{NCO_OFF_N - 3} at a {NCO_WIDE_HZ:.0f} Hz loop",
                  x[:4, :NCO_OFF_N - 3].contiguous(), wide, phase[:4],
                  freq[:4])

    args = (scale(x), *gains, phase, freq)
    counts = (knco.redone.read(card), knco.starved.read(card))
    ms = time_ms(lambda: knco.nco_pll_subcarrier_rows(x, *args), reps=5,
                 warmup=1)
    (_, device_ms), = [(k, t) for k, t in kernel_times_ms(
        lambda: knco.nco_pll_subcarrier_rows(x, *args), reps=3)
        if "nco_pll_kernel_phasor" in k]
    # The wbfm24 cells' shape, the loop designed for its rate: from phase
    # 0, as the cell's first chunk, so acquiring, against its plain loop;
    # then the same call's time.
    x24 = pilots(gen, len(W24_OFFSETS), W24_STATION, card, W24_STATION)
    z24 = torch.zeros(x24.shape[0], device=card)
    gains24 = pll_design(W24_STATION, 19e3, 50.0)
    against_plain(f"{x24.shape[0]}x{W24_STATION} acquiring from phase 0",
                  x24, gains24, z24, z24, held_from=NCO_ACQUIRE)
    args24 = (scale(x24), *gains24, z24, z24)
    (_, ms24), = [(k, t) for k, t in kernel_times_ms(
        lambda: knco.nco_pll_subcarrier_rows(x24, *args24), reps=3)
        if "nco_pll_kernel_phasor" in k]
    redid = knco.redone.read(card) - counts[0]
    starved = knco.starved.read(card) - counts[1]
    # Read the pilot and its scale, write the subcarrier; the state.
    least = bound(4 * (2 * x.numel() + 5 * rows), 21.0 * x.numel())
    latency_ms = min(probe["phasor", lanes][0] for lanes in (1, 32))
    print(f"[kernel] K-NCO subcarrier {rows}x{n}: kernel {ms:.3f} ms "
          f"between CUDA events, {device_ms:.3f} ms device time; "
          f"{device_ms * 1e-3 * mhz * 1e6 / n:.1f} cycles a sample at "
          f"{mhz:.0f} MHz; least {latency_ms:.3f} ms by latency (the "
          f"phasor chain over a row: {latency_ms / device_ms:.1%}), "
          f"{least['bound_ms']:.3f} ms by {least['bound_by']}; "
          f"{x24.shape[0]}x{W24_STATION}: {ms24:.3f} ms device time, "
          f"{ms24 * 1e-3 * mhz * 1e6 / W24_STATION:.1f} cycles a sample; "
          f"over the timed calls of both shapes and the {x24.shape[0]}x"
          f"{W24_STATION} check redone {redid}, starved {starved}; plain "
          f"loops {plain_s[0]:.1f} s on the host; no library call")
    if redid or starved:
        raise AssertionError(f"K-NCO subcarrier on locked pilots: redone "
                             f"{redid}, starved {starved}")
    if latency_ms > least["bound_ms"]:
        least = dict(bound_ms=latency_ms, bound_by="latency")
    return dict(kernel="nco_pll_kernel_phasor", max_abs_err=max(errs),
                ms=ms, device_ms=device_ms, plain_ms=plain_s[0] * 1e3,
                plain_shape=f"2 x {rows}x{n}, {rows}x{NCO_OFF_N}, "
                f"4x{NCO_OFF_N - 3}, {x24.shape[0]}x{W24_STATION}", **least)


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
    step, state, bands, audios, counts = run_main_path(
        device, gen, chunks=CHUNKS_EXACT, mode="exact")
    band1, audio1 = bands[0], audios[0]
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
    del step, state, bands, audios, band1, audio1, band
    fast_step, _ = _fast_step(c, device)
    fast = check_station("exact station, fast mode", fast_step, c, device)
    db = [snr_db(exact[1000:-1000, ch], fast[1000:-1000, ch])
          for ch in range(2)]
    print(f"[exact] fast against exact on the station's audio: left "
          f"{db[0]:.1f} dB, right {db[1]:.1f} dB (bound "
          f"{FAST_EXACT_MIN_DB:.0f} dB)")
    if not min(db) > FAST_EXACT_MIN_DB:
        raise AssertionError(f"fast against exact: {db} dB")


def _fast_step(c, device, extract_demod="off", routes=None):
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    return make_multi_station_step(
        c * STATION, offsets(c, STATION), STATION, AUDIO, mode="fast",
        extract_demod=extract_demod, device=device, routes=routes)


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


def check_dead_step(device, gen, extract_ifft=()) -> None:
    """Phase 13: whole steps on a 64-station spectrum in which two
    stations' bins are exactly zero, in all three ``extract_demod``
    modes: the dead stations' audio is finite and, like the live
    stations', equal to the port's on the CPU. With ``extract_ifft``
    (phase 16) the ``fast`` step under each of those extraction routes
    instead: the dead stations' IQ and quad exactly 0, and every
    station's audio within the bound of the default routes'."""
    import torch
    from radiocore_tpu_torch.ops.channelize import uniform_extraction_start
    from radiocore_tpu_torch.ops.demod import quadrature_demod
    from radiocore_tpu_torch.runtime.routes import Routes

    c, m, n = N_STATIONS, STATION, N_BAND
    dead = [c // 2, c - 1]
    live = [i for i in range(c) if i not in dead]
    spec = torch.fft.fft(fm_band(gen, c, m, device))
    a0 = uniform_extraction_start(n, tuple(-o for o in offsets(c, m)), m)
    for i in dead:
        bins = (a0 + i * m + torch.arange(m + 1, device=device)) % n
        spec[bins] = 0

    def tail(dev, sp, xd="off", routes=None):
        step, state = _fast_step(c, dev, xd, routes)
        _, middle, last = step.stages.values()
        iq = middle(sp)
        return iq, last(iq, state)[0]

    failures = []
    if not extract_ifft:
        spec_cpu = spec.cpu()
        for xd in ("off", "fused", "spec"):
            card = tail(device, spec, xd)[1].cpu()
            cpu = tail("cpu", spec_cpu, xd)[1]
            finite = bool(torch.isfinite(card[dead]).all())
            e_dead = (max_abs(card[dead], cpu[dead]) if finite
                      else float("nan"))
            e_live = max_abs(card[live], cpu[live])
            print(f"[dead] step extract_demod={xd!r}, stations {dead} "
                  f"zeroed: their audio finite {finite}, card vs CPU "
                  f"max_abs {e_dead:.3e}, live stations {e_live:.3e} "
                  f"(bound {E2E_ABS_MAX:.0e})")
            if not (finite and e_dead <= E2E_ABS_MAX
                    and e_live <= E2E_ABS_MAX):
                failures.append(f"{xd}: finite {finite}, dead {e_dead}, "
                                f"live {e_live}")
    else:
        want = tail(device, spec)[1]
    for impl in extract_ifft:
        iq, audio = tail(device, spec, routes=Routes(extract_ifft=impl))
        quad = quadrature_demod(iq)
        zero = (bool((iq[dead] == 0).all())
                and bool((quad[dead] == 0).all()))
        finite = bool(torch.isfinite(audio).all())
        err = max_abs(audio, want) if finite else float("nan")
        print(f"[routes] dead stations {dead}, extract_ifft={impl!r}: IQ "
              f"and quad exactly 0 {zero}; audio finite {finite}, against "
              f"the default routes' max_abs {err:.3e} (bound "
              f"{ROUTE_ABS_MAX:.0e})")
        if not (zero and finite and err <= ROUTE_ABS_MAX):
            failures.append(f"extract_ifft={impl}: zero {zero}, finite "
                            f"{finite}, error {err}")
    if failures:
        raise AssertionError("dead stations through a whole step: "
                             + "; ".join(failures))


# ---------------------------------------------------------------------------
# Phase 16: the routes (``runtime/routes.Routes``) at the main plans.
# ---------------------------------------------------------------------------
ROUTE_CHUNKS = 2
ROUTE_ABS_MAX = 1e-4   # audio against the default routes', on the card
ROUTE_ENTRIES = tuple(f"K-FFT {e}" for e in (
    "fft_pow2", "ifft_pow2", "rfft_pow2", "irfft_pow2"))
# (label, stations, mode, Routes fields, counts that must stay 0, counts
# that must exceed the default routes' on the same plan and mode).
ROUTE_CASES = (
    ("fast extract_ifft=native", N_STATIONS, "fast",
     {"extract_ifft": "native"}, ("K-EXTRACT",), ()),
    ("fast extract_ifft=fourstep", N_STATIONS, "fast",
     {"extract_ifft": "fourstep"}, ("K-EXTRACT",), ()),
    ("fast extract_ifft=pallas", N_STATIONS, "fast",
     {"extract_ifft": "pallas"}, ("K-EXTRACT",), ("K-FFT ifft_pow2",)),
    ("fast station_rfft=native", N_STATIONS, "fast",
     {"station_rfft": "native"}, ("K-FFT rfft_pow2",), ()),
    ("fast env_fft=pallas", N_STATIONS, "fast", {"env_fft": "pallas"},
     (), ("K-FFT ifft_pow2", "K-FFT rfft_pow2")),
    ("fast fir_impl=fft", N_STATIONS, "fast", {"fir_impl": "fft"},
     ("K-FIR",), ()),
    ("fast fir_impl=conv", N_STATIONS, "fast", {"fir_impl": "conv"},
     ("K-FIR",), ()),
    ("exact fft_kernel_min=2^16", N_STATIONS, "exact",
     {"fft_kernel_min": 1 << 16}, (), ROUTE_ENTRIES),
    ("fast fft_mixed_min=0", N_STATIONS_96, "fast", {"fft_mixed_min": 0},
     ("K-MIXED",), ()),
)
DEAD_ROUTES = ("native", "fourstep", "pallas")


def entry_counters() -> dict:
    """K-FFT's launch counters by entry, named as in ``KERNELS``."""
    from radiocore_tpu_torch.kernels import fft_rows
    return {e: fft_rows.entry_launches[e.split()[1]] for e in ROUTE_ENTRIES}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def check_routes(device, gen, card: str) -> dict:
    """Phase 16: ``make_multi_station_step`` under explicit ``Routes``
    (never the environment) at 64 x 262 144 and, for K-MIXED's threshold,
    96 x 262 144: each route's step time (CUDA events), launches by kernel
    and K-FFT entry, and audio against the default routes' on the card
    over the same chunks; then the extraction routes on dead stations.
    Returns each run's launches by its label."""
    from radiocore_tpu_torch.runtime.routes import Routes

    plans, runs, failures = {}, {}, []
    for label, c, mode, fields, zero, more in ROUTE_CASES:
        if (c, mode) not in plans:
            _, _, bands, want, base = run_main_path(
                device, gen, c=c, chunks=ROUTE_CHUNKS, mode=mode,
                also=entry_counters())
            plans[(c, mode)] = (bands, want, base)
            runs[f"{c} {mode}, default routes"] = base
            print(f"[routes] {c} x {STATION} {mode}, default routes, "
                  f"{ROUTE_CHUNKS} chunks: launches {_nonzero(base)}")
        bands, want, base = plans[(c, mode)]
        step, state, _, audios, counts = run_main_path(
            device, gen, c=c, mode=mode, routes=Routes(**fields),
            bands=bands, also=entry_counters())
        runs[f"{c} {label}"] = counts
        err = max(max_abs(a, w) for a, w in zip(audios, want))
        print(f"[routes] {c} x {STATION} {label}: "
              f"{step_ms(step, bands[0], state)}; {card}; launches in "
              f"{ROUTE_CHUNKS} chunks {_nonzero(counts)}; audio against "
              f"the default routes' max_abs {err:.3e} (bound "
              f"{ROUTE_ABS_MAX:.0e})")
        bad = ([f"{k} launched {counts[k]} times" for k in zero
                if counts[k]]
               + [f"{k} {counts[k]} launches, default {base[k]}"
                  for k in more if counts[k] <= base[k]])
        if not err <= ROUTE_ABS_MAX:
            bad.append(f"audio {err} from the default routes'")
        if bad:
            failures.append(f"{label}: " + ", ".join(bad))
        del step, state, audios
    del plans
    if failures:
        raise AssertionError("[routes]: " + "; ".join(failures))
    check_dead_step(device, gen, DEAD_ROUTES)
    return runs


# ---------------------------------------------------------------------------
# Phase 19, [graphs]: the compiled steps (runtime/graphs) against their
# eager bodies, at the sizes of the phases that drive them.
# ---------------------------------------------------------------------------
GRAPH_REL_MAX = 1e-6    # graph against eager, of the eager output's max
GRAPH_REPS = 10


def tensors(tree) -> list:
    """The tensor leaves of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return [tree] if hasattr(tree, "data_ptr") else []


def kernel_counters() -> dict:
    """Every kernel's launch counter and K-FFT's by entry, by name."""
    from radiocore_tpu_torch.kernels import (extract, extract_demod as xd,
                                             fft_band, fft_mixed, fft_rows,
                                             fir, nco_pll, quad_demod)
    return {"K-FFT": fft_rows.launches,
            **{f"K-FFT {e}": c for e, c in fft_rows.entry_launches.items()},
            "K-MIXED": fft_mixed.launches, "K-EXTRACT": extract.launches,
            "K-GATHER": extract.gather_launches, "K-XDEMOD": xd.launches,
            "K-XDEMOD-SPEC": xd.spec_launches,
            "K-FIR": fir.launches, "K-NCO": nco_pll.launches,
            "K-QDEMOD": quad_demod.launches, "K-BANDFFT": fft_band.launches}


def times_ms(fn):
    """``GRAPH_REPS`` calls of ``fn()``: the min and median of their
    CUDA-event times and the host's time to enqueue one (its clock
    around the calls, before the synchronize)."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    t0 = time.perf_counter()
    for _ in range(GRAPH_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    host = (time.perf_counter() - t0) * 1e3 / GRAPH_REPS
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in pairs]
    return min(ms), statistics.median(ms), host


def drive_graph(label, step, chunks, state=None, extra=(), card="") -> None:
    """One compiled step against its eager body (``step.eager``) on two
    chunks, chained through the state when ``state`` is given, each
    call ``step(chunk[, state], *extra)``: outputs bit for bit (or within
    ``GRAPH_REL_MAX`` of the max), launches a call by kernel and K-FFT
    entry equal to eager's, chunk 1's outputs unchanged by chunk 2, two
    calls from ``state`` equal; device and host times of both, the
    inputs' copy-in and the outputs' clone-out, ``max_memory_reserved``.
    Raises on a failed check."""
    import torch

    def call(fn, x, st):
        return fn(x, *(() if state is None else (st,)), *extra)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    g0 = call(step, chunks[0], state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    held = [t.clone() for t in tensors(g0)]
    s1 = None if state is None else g0[1]
    g1 = call(step, chunks[1], s1)
    again = call(step, chunks[0], state)
    pairs = [(g, call(step.eager, x, st))
             for g, x, st in ((g0, chunks[0], state), (g1, chunks[1], s1))]
    bitwise, err, scale = True, 0.0, 0.0
    for g, e in pairs:
        for a, b in zip(tensors(g), tensors(e)):
            bitwise &= bool(torch.equal(a, b))
            if a.is_floating_point() or a.is_complex():
                err = max(err, float((a - b).abs().max()))
                scale = max(scale, float(b.abs().max()))
    held_ok = all(torch.equal(h, t) for h, t in zip(held, tensors(g0)))
    twice = all(torch.equal(a, b)
                for a, b in zip(tensors(again), tensors(g0)))
    counters = kernel_counters()

    def per_call(fn):
        torch.cuda.synchronize()
        for c in counters.values():
            c.reset()
        call(fn, chunks[1], s1)
        torch.cuda.synchronize()
        return {k: c.count for k, c in counters.items() if c.count}

    launches, eager_launches = per_call(step), per_call(step.eager)
    graph_t = times_ms(lambda: call(step, chunks[1], s1))
    eager_t = times_ms(lambda: call(step.eager, chunks[1], s1))
    ins = tensors((chunks[1], s1, extra))
    bufs = [torch.empty_like(t) for t in ins]
    copy_in = time_ms(lambda: [b.copy_(t) for b, t in zip(bufs, ins)],
                      reps=GRAPH_REPS)
    clone_out = time_ms(lambda: [t.clone() for t in tensors(g1)],
                        reps=GRAPH_REPS)
    reserved = torch.cuda.max_memory_reserved() / 1e9
    same = ("bit for bit" if bitwise else
            f"max_abs {err:.3e} of max {scale:.3e} (bound "
            f"{GRAPH_REL_MAX:.0e} of the max)")
    print(f"[graphs] {label}: first call {first_s:.2f} s (warm-up and "
          f"capture); graph vs eager {same}; launches a call {launches} "
          f"(eager {eager_launches}); chunk 1 held across chunk 2 "
          f"{held_ok}; two calls from state0 equal {twice}; graph "
          f"{graph_t[0]:.3f} / {graph_t[1]:.3f} ms (min / median of "
          f"{GRAPH_REPS}), host enqueue {graph_t[2]:.3f}; eager "
          f"{eager_t[0]:.3f} / {eager_t[1]:.3f}, host enqueue "
          f"{eager_t[2]:.3f}; copy-in {copy_in:.3f} ms, clone-out "
          f"{clone_out:.3f} ms; max_memory_reserved {reserved:.2f} GB; "
          f"{card}", flush=True)
    bad = []
    if not (bitwise or err <= GRAPH_REL_MAX * scale):
        bad.append(f"graph and eager differ by {err} (max {scale})")
    if launches != eager_launches:
        bad.append(f"launches {launches}, eager {eager_launches}")
    if not held_ok:
        bad.append("chunk 1's outputs changed by chunk 2")
    if not twice:
        bad.append("two calls from state0 differ")
    if bad:
        raise AssertionError(f"[graphs] {label}: " + "; ".join(bad))


def check_graphs(device, gen, card: str) -> None:
    """Phase 19: every compiled entry (``runtime/graphs``) at the sizes of
    the eager phases that drive it."""
    import gc
    import torch
    from radiocore_tpu_torch import models
    from radiocore_tpu_torch.apps.iq import SyntheticFmSource
    from radiocore_tpu_torch.models.wbfm import (make_wbfm_step,
                                                 wbfm_init_state)
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    from radiocore_tpu_torch.runtime.graphs import compile_step
    from radiocore_tpu_torch.runtime.routes import Routes
    from radiocore_tpu_torch.tools.tuner import Tuner

    def done():
        gc.collect()
        torch.cuda.empty_cache()

    plans = (  # label, stations, mode, extract_demod, routes
        ("main fast", N_STATIONS, "fast", "off", None),
        ("main exact", N_STATIONS, "exact", "off", None),
        ("fast fir_impl=fft", N_STATIONS, "fast", "off",
         Routes(fir_impl="fft")),
        ("fast fir_impl=conv", N_STATIONS, "fast", "off",
         Routes(fir_impl="conv")),
        ("exact fft_kernel_min=2^16", N_STATIONS, "exact", "off",
         Routes(fft_kernel_min=1 << 16)),
        ("96 off", N_STATIONS_96, "fast", "off", None),
        ("96 fused", N_STATIONS_96, "fast", "fused", None),
        ("96 spec", N_STATIONS_96, "fast", "spec", None),
    )
    bands = {}
    for label, c, mode, xd, routes in plans:
        if c not in bands:
            bands = {c: [fm_band(gen, c, STATION, device) for _ in range(2)]}
        step, state = make_multi_station_step(
            c * STATION, offsets(c, STATION), STATION, AUDIO, mode=mode,
            extract_demod=xd, device=device, routes=routes)
        drive_graph(f"{label}, {c} x {STATION}", step, bands[c], state,
                    card=card)
        del step, state
        done()
    del bands

    iq = [fm_stations(gen, N_STATIONS, STATION, device).to(torch.complex64)
          for _ in range(2)]
    step = compile_step(make_wbfm_step(STATION, AUDIO, mode="exact",
                                       pll="nco"), device)
    drive_graph(f"nco, {N_STATIONS} x {STATION} (the WBFM(pll='nco') "
                f"step)", step, iq,
                wbfm_init_state(AUDIO, batch_shape=(N_STATIONS,), pll="nco",
                                device=device), card=card)
    del step, iq
    done()

    band_np, offs, _ = config5_band()
    b5 = torch.from_numpy(band_np).to(device)
    for mode in ("fast", "exact"):
        step, state = make_multi_station_step(
            C5_BAND, offs, C5_STATION, C5_AUDIO, mode=mode, device=device)
        drive_graph(f"config5 {mode}, {C5_STATIONS} x {C5_STATION}", step,
                    [b5, torch.roll(b5, 4096)], state, card=card)
        del step, state
    del b5
    done()

    # receive_fm's defaults: 2.4 MS/s -> 240 kS/s -> 48 kHz.
    rx_in, rx_demod, rx_audio = 2_400_000, 240_000, 48_000
    src = SyntheticFmSource(rx_in, [0], rx_demod, seed=SEED)
    raw = [torch.from_numpy(src.read_chunk(1.0)).to(device)
           for _ in range(2)]
    dec = models.Decimate(rx_in, rx_demod, device=device)
    drive_graph(f"Decimate {rx_in} -> {rx_demod}", dec._run, raw,
                card=card)
    station = [dec.run(x) for x in raw]
    for name in ("WBFM", "MFM", "FM"):
        obj = getattr(models, name)(rx_demod, rx_audio, device=device)
        drive_graph(f"{name} {rx_demod} -> {rx_audio}", obj._step, station,
                    getattr(obj, "_state", None), card=card)
        del obj
    del raw, station, dec
    done()

    tuner = Tuner(device=device)
    for off in offsets(N_STATIONS, STATION):
        tuner.add_channel(100e6 + off, STATION, None)
    two = [fm_band(gen, N_STATIONS, STATION, device) for _ in range(2)]
    drive_graph(f"Tuner.load band FFT, 2^24", tuner._band_fft, two,
                card=card)
    spectra = []
    for band in two:
        tuner.load(band)
        spectra.append(tuner._spectrum)
    tuner.run_all()
    drive_graph(f"Tuner.run_all, {N_STATIONS} x {STATION}",
                tuner._extract_all[1], spectra, card=card)
    ch = tuner.channels()[1]
    drive_graph(f"Tuner.run(1), {STATION}", tuner._run_one, spectra,
                extra=(tuner._shift(ch), int(ch.bandwidth)), card=card)
    del tuner, two, spectra
    done()


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
    """Keeps every chunk of audio it is given, and the host's clock at
    each write."""

    def __init__(self):
        self.chunks = []
        self.times = []

    def write(self, audio):
        import numpy as np
        self.chunks.append(np.array(audio, copy=True))
        self.times.append(time.perf_counter())

    def close(self):
        pass


def stage_timer():
    """A ``StageTimer`` that also keeps each stage's times, so that the
    steady state (every chunk after the first, whose call builds the
    step's graph) can be told from the mean."""
    import contextlib
    from radiocore_tpu_torch.runtime.profiling import StageTimer

    class Timer(StageTimer):
        def __init__(self):
            super().__init__()
            self.times = {}

        @contextlib.contextmanager
        def stage(self, name, sync_value=None):
            t0 = time.perf_counter()
            with super().stage(name, sync_value):
                yield
            self.times.setdefault(name, []).append(time.perf_counter() - t0)

        def steady_ms(self) -> str:
            """Each stage's median over the calls after its first."""
            return ", ".join(
                f"{k} {statistics.median(v[1:]) * 1e3:.2f} ms"
                for k, v in self.times.items() if len(v) > 1)

    return Timer()


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
    metrics, timer = Metrics(), stage_timer()
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
    done = sinks[0].times
    print(f"[serve_fused] steady state, chunks 2-{APPS_CHUNKS} (chunk 1 "
          f"builds the step's graph): "
          f"{(len(done) - 1) / (done[-1] - done[0]):.2f} chunks/s; stage "
          f"medians {timer.steady_ms()}")
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
        metrics, timer = Metrics(), stage_timer()
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
                  for k, v in timer.report().items())
              + f"; medians after the first chunk {timer.steady_ms()}")
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



# Phase 18, [config5]: the config-5 rehearsal of tests/test_config5.py,
# 128 stations of 50 000 S/s to 10 000 audio samples in a 6.4 M band of
# SyntheticFmSource stations. 50 000 is not a power of two: K-GATHER (one
# launch a step) and cuFFT serve the plan. K-FIR takes the exact mode's
# pilot filter (forward and backward); the de-emphasis of 10 000 samples
# is below K-FIR's 16 384-sample minimum (the reference's rule), so it
# runs its plain version.
C5_STATIONS, C5_STATION, C5_AUDIO = 128, 50_000, 10_000
C5_BAND = C5_STATIONS * C5_STATION
C5_SLOTS = (0, 64, 127)
C5_TONE_MIN_DB = 6.0          # tests/test_config5.py:69-75
C5_FIR_PER_STEP = {"exact": 2, "fast": 0}
C5_ROUTE = ("50 000 is not a power of two: K-GATHER and cuFFT; K-FIR "
            "for the exact pilot filter, the 10 000-sample de-emphasis "
            "below K-FIR's minimum length")


def config5_band():
    """The config-5 band (host complex64), its offsets and its tones."""
    from radiocore_tpu_torch.apps.iq import SyntheticFmSource
    offs = offsets(C5_STATIONS, C5_STATION)
    tones = [(300.0 + (i % 40) * 90.0, 800.0 + (i % 40) * 90.0)
             for i in range(C5_STATIONS)]
    band = SyntheticFmSource(C5_BAND, offs, C5_STATION,
                             tones=tones).read_chunk(1.0)
    return band, offs, tones


def config5_tones(audio, tones) -> dict:
    """Both tones' SNR of stations ``C5_SLOTS`` in host audio; raise
    below the bound."""
    from oracles import tone_snr_db
    snr = {i: tuple(tone_snr_db(audio[i, 500:-500, ch], C5_AUDIO,
                                tones[i][ch]) for ch in (0, 1))
           for i in C5_SLOTS}
    if not min(min(v) for v in snr.values()) > C5_TONE_MIN_DB:
        raise AssertionError(f"config 5: tone SNR {snr} below "
                             f"{C5_TONE_MIN_DB} dB")
    return snr


def check_config5(device, card: str) -> None:
    """The config-5 plan in one process on the card, ``exact`` and
    ``fast``: launches (``C5_FIR_PER_STEP`` K-FIR, one K-GATHER, no
    other kernel), audio
    against the port on the CPU, the tones of three stations, the step
    time."""
    import torch
    from radiocore_tpu_torch.kernels import extract, fft_mixed, fft_rows, fir
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    band_np, offs, tones = config5_band()
    band = torch.from_numpy(band_np).to(device)
    counters = {"K-FFT": fft_rows.launches, "K-MIXED": fft_mixed.launches,
                "K-EXTRACT": extract.launches,
                "K-GATHER": extract.gather_launches, "K-FIR": fir.launches}
    for mode, fir_per_step in C5_FIR_PER_STEP.items():
        step, state = make_multi_station_step(
            C5_BAND, offs, C5_STATION, C5_AUDIO, mode=mode, device=device)
        torch.cuda.synchronize()
        for counter in counters.values():
            counter.reset()
        audio, _ = step(band, state)
        torch.cuda.synchronize()
        launches = {k: c.count for k, c in counters.items()}
        if tuple(audio.shape) != (C5_STATIONS, C5_AUDIO, 2) or not bool(
                torch.isfinite(audio).all()):
            raise AssertionError(f"config 5 {mode}: audio "
                                 f"{tuple(audio.shape)} not finite")
        step_cpu, state_cpu = make_multi_station_step(
            C5_BAND, offs, C5_STATION, C5_AUDIO, mode=mode, device="cpu")
        want, _ = step_cpu(torch.from_numpy(band_np), state_cpu)
        err = max_abs(audio.cpu(), want)
        snr = config5_tones(audio.cpu().numpy(), tones)
        print(f"[config5] {mode} {C5_STATIONS} x {C5_STATION} -> "
              f"{C5_AUDIO} in a {C5_BAND} band ({C5_ROUTE}): launches "
              f"{launches}; card vs CPU max_abs {err:.3e} (bound "
              f"{E2E_ABS_MAX:.0e}); tones "
              + ", ".join(f"station {i} {l:.1f} / {r:.1f} dB"
                          for i, (l, r) in snr.items())
              + f" (bound {C5_TONE_MIN_DB:.0f} dB); "
              f"{step_ms(step, band, state)}; {card}")
        if launches != {"K-FFT": 0, "K-MIXED": 0, "K-EXTRACT": 0,
                        "K-GATHER": 1, "K-FIR": fir_per_step}:
            raise AssertionError(f"config 5 {mode}: launches {launches}")
        if not err <= E2E_ABS_MAX:
            raise AssertionError(f"config 5 {mode}: card and CPU audio "
                                 f"differ by {err}")
        del step, state, audio, want


# Phase 15, [parallel]: a world of two ranks on one card over gloo (NCCL
# refuses two ranks on one device). It proves that the sharded
# algorithms compute the right thing with the card's kernels inside them;
# its times are not a scaling figure.
PAR_RANKS = 2
PAR_CHUNKS = 3
PAR_FIR_TAPS = 51
HALO_FIR_TAPS = 129           # the config-4 band FIR
PFB_CHANNELS, PFB_P = 64, 8
IQ_REL_L2_MAX = 1e-5          # the distributed front end against complex128
EXTRACT_REL_MAX = 3e-4        # of max |ref|, tests/test_parallel.py:216
SHARDED_FIR_MAX = 1e-6        # sharded K-FIR against K-FIR (0 expected)
PFB_ABS_MAX = 2e-6            # tests/test_halo_streaming.py:76


def _par_wall(fn):
    """``fn()``'s result and its wall time in ms, the card synchronized."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _par_bytes(mesh, steps: int = 1) -> str:
    """The mesh's collective bytes and host seconds per step, by kind."""
    from radiocore_tpu_torch.parallel.comm_analysis import collective_bytes
    got = collective_bytes(mesh.counter)
    secs = mesh.counter.seconds
    return ", ".join(
        f"{k} {v // steps} B" + (f" in {secs[k] / steps * 1e3:.1f} ms"
                                 if k in secs else "")
        for k, v in got.items())


def parallel_rank(rank: int, label: str) -> None:
    """One rank of ``[parallel]``: the mesh step in ``fast`` and ``exact``
    at the main plan (distributed front end), the mesh step on the
    all-gather branch, the config-4 form (halo overlap-save FIR and the
    distributed extraction), the sharded K-FIR and the streaming sharded
    PFB, each against the unsharded path on the card; raises on any
    failure, which fails the world."""
    import torch
    from scipy import signal as sig
    from radiocore_tpu_torch.kernels import extract, fft_rows, fir
    from radiocore_tpu_torch.ops.channelize import (make_extractor,
                                                    uniform_extraction_start)
    from radiocore_tpu_torch.ops.fft import fft
    from radiocore_tpu_torch.ops.fir import fir_overlap_save
    from radiocore_tpu_torch.ops.pfb import (pfb_channelize, pfb_init,
                                             pfb_taps)
    from radiocore_tpu_torch.parallel.channelize_sharded import (
        make_extract_body)
    from radiocore_tpu_torch.parallel.halo import (fir_causal_sharded,
                                                   fir_overlap_save_halo,
                                                   pfb_channelize_halo)
    from radiocore_tpu_torch.parallel.mesh import (FLAT, TIME,
                                                   make_radio_mesh, shard,
                                                   station_sharding)
    from radiocore_tpu_torch.parallel.pipeline import (
        gather_stations, make_multi_station_step)

    tag = f"[parallel] rank {rank}"
    mesh = make_radio_mesh(stations=PAR_RANKS, time=1)
    tmesh = make_radio_mesh(stations=1, time=PAR_RANKS)
    device = mesh.device
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    c, sc, n = N_STATIONS, STATION, N_BAND
    offs = offsets(c, sc)
    shifts = tuple(-o for o in offs)
    bands = [fm_band(gen, c, sc, device) for _ in range(PAR_CHUNKS)]
    counters = {"K-FFT": fft_rows.launches, "K-EXTRACT": extract.launches,
                "K-GATHER": extract.gather_launches, "K-FIR": fir.launches}
    mine = station_sharding(mesh, c)

    def run_steps(step, state, chunks):
        torch.cuda.synchronize()
        for ctr in counters.values():
            ctr.reset()
        mesh.counter.reset()
        audios, walls = [], []
        for band in chunks:
            (audio, state), ms = _par_wall(
                lambda: step(shard(band, mesh, FLAT), state))
            audios.append(audio)
            walls.append(ms)
        return audios, walls, {k: v.count for k, v in counters.items()}

    def against_one_process(what, mode, offs_, chunks, audios,
                            plan=(n, sc, AUDIO)):
        ref_step, ref_state = make_multi_station_step(
            plan[0], offs_, plan[1], plan[2], mode=mode, device=device)
        worst = 0.0
        for band, audio in zip(chunks, audios):
            want, ref_state = ref_step(band, ref_state)
            worst = max(worst, max_abs(gather_stations(audio, mesh), want))
        print(f"{tag} {what}: gathered audio against the one-process step "
              f"on the card max_abs {worst:.3e} (bound {E2E_ABS_MAX:.0e})",
              flush=True)
        if not worst <= E2E_ABS_MAX:
            raise AssertionError(f"{what}: audio off by {worst}")

    for mode in ("fast", "exact"):
        step, state = make_multi_station_step(n, offs, sc, AUDIO, mode=mode,
                                              mesh=mesh)
        if not step.distributed:
            raise AssertionError("the main plan missed the distributed "
                                 "front end")
        audios, walls, launches = run_steps(step, state, bands)
        print(f"{tag} {mode} {c} x {sc} -> {AUDIO}, stations "
              f"{mine.start}..{mine.stop - 1}, {PAR_CHUNKS} chunks: "
              f"launches {launches}; collectives a step: "
              f"{_par_bytes(mesh, PAR_CHUNKS)}; step wall "
              + ", ".join(f"{ms:.1f}" for ms in walls)
              + f" ms ({label})", flush=True)
        # fast: the station rfft (K-FFT) and de-emphasis (K-FIR); exact:
        # three K-FIR launches a step. The band's local transforms (4096
        # and 2^18 points) are below the default fft_kernel_min: cuFFT.
        fir_per_step = 3 if mode == "exact" else 1
        if ((mode == "fast" and launches["K-FFT"] <= 0)
                or launches["K-FIR"] != fir_per_step * PAR_CHUNKS):
            raise AssertionError(f"{mode}: launches {launches}")
        against_one_process(mode, mode, offs, bands, audios)
        if mode == "fast":
            iq = step.stages["front_end"](shard(bands[0], mesh, FLAT))
            a0 = uniform_extraction_start(n, shifts, sc)
            ref = extract.extract_rows_plain(
                torch.fft.fft(bands[0].to(torch.complex128)), a0, c, sc,
                1.0 / n)[mine]
            err = rel_l2(iq, ref)
            print(f"{tag} distributed front end: station IQ rel_l2 "
                  f"{err:.3e} of complex128 (bound {IQ_REL_L2_MAX:.0e})",
                  flush=True)
            if not err <= IQ_REL_L2_MAX:
                raise AssertionError(f"front end: rel_l2 {err}")
        del step, state, audios

    # The all-gather branch: the 62 inner stations of the band (a uniform
    # plan that does not tile it) gather the band, and each rank's 31
    # stations go through K-EXTRACT.
    offs62 = offs[1:-1]
    step, state = make_multi_station_step(n, offs62, sc, AUDIO, mode="fast",
                                          mesh=mesh)
    if step.distributed:
        raise AssertionError("62 stations took the distributed front end")
    audios, walls, launches = run_steps(step, state, bands[:1])
    print(f"{tag} all-gather branch, fast, {len(offs62)} x {sc} in a 2^24 "
          f"band: launches {launches}; collectives a step: "
          f"{_par_bytes(mesh)}; step wall {walls[0]:.1f} ms ({label})",
          flush=True)
    if launches["K-EXTRACT"] <= 0:
        raise AssertionError(f"all-gather branch: launches {launches}")
    against_one_process("all-gather branch", "fast", offs62, bands[:1],
                        audios)
    del step, state, audios

    # Config 5: 128 stations of 50 000 S/s in a 6.4 M band, both modes.
    band_np, offs5, tones5 = config5_band()
    band5 = torch.from_numpy(band_np).to(device)
    mine5 = station_sharding(mesh, C5_STATIONS)
    plan5 = (C5_BAND, C5_STATION, C5_AUDIO)
    for mode, fir_per_step in C5_FIR_PER_STEP.items():
        step, state = make_multi_station_step(
            C5_BAND, offs5, C5_STATION, C5_AUDIO, mode=mode, mesh=mesh)
        audios, walls, launches = run_steps(step, state, [band5])
        gathered = gather_stations(audios[0], mesh).cpu().numpy()
        snr = config5_tones(gathered, tones5)
        print(f"{tag} config 5 {mode} {C5_STATIONS} x {C5_STATION} -> "
              f"{C5_AUDIO} ({C5_ROUTE}), stations "
              f"{mine5.start}..{mine5.stop - 1}, "
              f"distributed front end {step.distributed}: launches "
              f"{launches}; collectives a step: {_par_bytes(mesh)}; step "
              f"wall {walls[0]:.1f} ms; tones "
              + ", ".join(f"station {i} {l:.1f} / {r:.1f} dB"
                          for i, (l, r) in snr.items())
              + f" ({label})", flush=True)
        # The all-gather branch extracts this rank's stations with
        # K-GATHER; the distributed front end has its own extraction.
        gathers = 0 if step.distributed else 1
        if launches != {"K-FFT": 0, "K-EXTRACT": 0, "K-GATHER": gathers,
                        "K-FIR": fir_per_step}:
            raise AssertionError(f"config 5 {mode}: launches {launches}")
        against_one_process(f"config 5 {mode}", mode, offs5, [band5],
                            audios, plan5)
        del step, state, audios
    del band5

    # The config-4 form over a time axis of 2.
    axis = tmesh.axis(TIME)
    taps = sig.firwin(HALO_FIR_TAPS, 0.45)
    body = make_extract_body(n, shifts, sc, PAR_RANKS, axis)
    band = bands[0]
    tmesh.counter.reset()
    got, ms = _par_wall(lambda: body(fir_overlap_save_halo(
        shard(band, tmesh), taps, axis)[0]))
    want = make_extractor(n, shifts, sc)(fft(fir_overlap_save(band, taps)))
    want = want[rank * c // PAR_RANKS:(rank + 1) * c // PAR_RANKS]
    err = max_abs(got, want) / float(want.abs().max())
    print(f"{tag} config 4 ({HALO_FIR_TAPS}-tap halo overlap-save FIR, "
          f"distributed extraction of {c} channels of a 2^24 band): "
          f"max_abs/max|ref| {err:.3e} (bound {EXTRACT_REL_MAX:.0e}); "
          f"collectives: {_par_bytes(tmesh)}; wall {ms:.1f} ms ({label})",
          flush=True)
    if not err <= EXTRACT_REL_MAX:
        raise AssertionError(f"config 4: {err}")
    del got, want

    # fir_causal_sharded at 51 taps over 2^24 float32: K-FIR on each
    # rank's block with its halo, against K-FIR on the whole signal.
    taps51 = sig.firwin(PAR_FIR_TAPS, 0.25)
    x = torch.randn(n, generator=gen, device=device)
    fir.launches.reset()
    tmesh.counter.reset()
    got, ms = _par_wall(lambda: fir_causal_sharded(shard(x, tmesh), taps51,
                                                   tmesh))
    kfir = fir.launches.count
    want = shard(fir.fir_causal_rows(x, taps51), tmesh)
    err = max_abs(got, want)
    print(f"{tag} fir_causal_sharded {PAR_FIR_TAPS} taps over 2^24 f32: "
          f"max_abs {err:.3e} against unsharded K-FIR (bound "
          f"{SHARDED_FIR_MAX:.0e}); K-FIR launches {kfir}; collectives: "
          f"{_par_bytes(tmesh)}; wall {ms:.1f} ms ({label})", flush=True)
    if kfir != 1 or not err <= SHARDED_FIR_MAX:
        raise AssertionError(f"fir_causal_sharded: {kfir} launches, {err}")
    del x, got, want

    # pfb_channelize_halo, 64 channels, P = 8, two chained chunks of 2^24.
    taps = pfb_taps(PFB_CHANNELS, PFB_P)
    hist = pfb_init(PFB_CHANNELS, PFB_P, device=device)
    ref_hist = pfb_init(PFB_CHANNELS, PFB_P, device=device)
    frames = n // PAR_RANKS // PFB_CHANNELS
    worst, walls = 0.0, []
    tmesh.counter.reset()
    for _ in range(2):
        chunk = crandn(gen, device, n)
        (ch, hist), ms = _par_wall(lambda: pfb_channelize_halo(
            shard(chunk, tmesh), taps, PFB_CHANNELS, axis,
            stream_history=hist))
        ref, ref_hist = pfb_channelize(chunk, taps, PFB_CHANNELS,
                                       history=ref_hist)
        walls.append(ms)
        worst = max(worst, max_abs(
            ch, ref[rank * frames:(rank + 1) * frames]))
    hist_err = max_abs(hist, ref_hist)
    print(f"{tag} pfb_channelize_halo {PFB_CHANNELS} channels, P = "
          f"{PFB_P}, 2 chunks of 2^24: max_abs {worst:.3e} against "
          f"unsharded (bound {PFB_ABS_MAX:.0e}), history {hist_err:.3e}; "
          f"collectives a chunk: {_par_bytes(tmesh, 2)}; wall "
          + ", ".join(f"{ms:.1f}" for ms in walls) + f" ms ({label})",
          flush=True)
    if not (worst <= PFB_ABS_MAX and hist_err <= 1e-7):
        raise AssertionError(f"pfb_channelize_halo: {worst}, {hist_err}")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# --paths / --compare: the default paths of two checkouts, on one card.
# ---------------------------------------------------------------------------
AB_PATHS = (("fast", N_STATIONS, "fast", "off"),
            ("exact", N_STATIONS, "exact", "off"),
            ("96 spec", N_STATIONS_96, "fast", "spec"))
AB_CHUNKS = 2
AB_DIR = Path("chiprun_out") / "paths"


def record_paths(tag: str) -> None:
    """The default paths of the package on ``sys.path``: step times and
    launches printed, audio hashes and launches to ``AB_DIR/tag.json``."""
    import hashlib
    import torch
    import radiocore_tpu_torch
    from radiocore_tpu_torch.kernels import build
    from radiocore_tpu_torch.runtime.platform import nvidia_smi_name_power

    card = nvidia_smi_name_power().splitlines()[0]
    print(f"[paths {tag}] package {Path(radiocore_tpu_torch.__file__).parent}")
    build.build()
    build.library()
    device = torch.device("cuda", 0)
    record = {}
    for label, c, mode, xd in AB_PATHS:
        gen = torch.Generator(device=device).manual_seed(SEED)
        step, state, _, audios, counts = run_main_path(
            device, gen, c=c, chunks=AB_CHUNKS, extract_demod=xd, mode=mode)
        band = fm_band(gen, c, STATION, device)
        print(f"[paths {tag}] {label}: {step_ms(step, band, state)}; "
              f"{card}; launches in {AB_CHUNKS} chunks {counts}")
        digest = hashlib.sha256()
        for audio in audios:
            digest.update(audio.cpu().contiguous().numpy().tobytes())
        record[label] = {"sha256": digest.hexdigest(), "launches": counts}
        del step, state, audios, band
    AB_DIR.mkdir(parents=True, exist_ok=True)
    (AB_DIR / f"{tag}.json").write_text(json.dumps(record))


def compare_paths(a: str, b: str) -> int:
    ra, rb = (json.loads((AB_DIR / f"{t}.json").read_text()) for t in (a, b))
    same = True
    for label in ra:
        audio = ra[label]["sha256"] == rb[label]["sha256"]
        counts = ra[label]["launches"] == rb[label]["launches"]
        print(f"[paths] {label}: {a} against {b}: audio bit for bit "
              f"{audio}, launches equal {counts} ({rb[label]['launches']})")
        same = same and audio and counts
    return 0 if same else 1


def main(argv=()) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 2
    if len(argv) == 3 and argv[0] == "--compare":
        return compare_paths(argv[1], argv[2])
    if argv and not (argv[0] == "--paths" and len(argv) in (2, 3)):
        print(__doc__, file=sys.stderr)
        return 2
    tree = Path(argv[2]).resolve() if len(argv) == 3 else REPO
    sys.path[:0] = [str(tree), str(REPO / "tests")]
    if argv:
        record_paths(argv[1])
        return 0
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
    # runs: K-FFT's entries' launches by the run that made them.
    kstats, launches, main_step, runs = {}, {}, {}, {}

    def phase_main():
        # Phase 2: kernels against their plain versions.
        kstats.update(check_kernels(device, gen))
        lap("kernels at the main shapes")
        # Phase 3: the main path.
        step, state, bands, audios, counts = run_main_path(
            device, gen, also=entry_counters())
        band1, audio1 = bands[0], audios[0]
        runs[f"{N_STATIONS} fast, main path"] = counts
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

    def phase_gather():
        # K-GATHER at the benchmark's wbfm24 plan.
        kstats["K-GATHER"], launches["K-GATHER"] = check_gather(device, gen)
        lap("K-GATHER at the wbfm24 plan")

    def phase_qdemod():
        kstats["K-QDEMOD"] = check_quad_demod(device, gen)
        lap("K-QDEMOD at the wbfm24 shape")

    def phase_bandfft():
        kstats["K-BANDFFT"], launches["K-BANDFFT"] = check_band_fft(device,
                                                                    gen)
        lap("K-BANDFFT at the 10 MS/s band")

    def phase_mixed():
        # Phase 20: the mixed24 cell's step, WBFM, MFM and FM.
        check_mixed(device, gen)
        lap("[mixed] the mixed24 step")

    def phase_bands():
        # Phase 21: the wbfm48_2band cell's step, two bands.
        check_bands(device, gen)
        lap("[bands] the wbfm48_2band step")

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
            step, state, bands, audios, counts = run_main_path(
                device, gen, c=c, chunks=chunks, extract_demod=xd)
            band1, audio1 = bands[0], audios[0]
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
            del step, state, bands, audios, band1, audio1, band
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

    def phase_routes():
        # Phase 16: explicit routes; the K-FFT entries' launches.
        runs.update(check_routes(device, gen, smi.splitlines()[0]))
        lap("[routes]")

    def phase_graphs():
        # Phase 19: the compiled steps against their eager bodies.
        check_graphs(device, gen, smi.splitlines()[0])
        lap("[graphs]")

    def phase_acceptance():
        # Phase 17: the port's acceptance drive, every config, on the card.
        from radiocore_tpu_torch.tools import acceptance
        print(f"[acceptance] tools.acceptance on {smi.splitlines()[0]}",
              flush=True)
        rc = acceptance.main(["--configs", "1,2,3,4",
                              "--fidelity", "1,2,3"])
        if rc != 0:
            raise AssertionError(f"[acceptance] FAIL (exit {rc})")
        lap("[acceptance]")

    def phase_config5():
        # Phase 18: 128 stations of 50 000 S/s in one process.
        check_config5(device, smi.splitlines()[0])
        lap("[config5]")

    def phase_parallel():
        # Phase 15: two ranks on this card over gloo.
        from radiocore_tpu_torch.parallel.dryrun import run_world
        torch.cuda.empty_cache()
        run_world(parallel_rank, PAR_RANKS,
                  f"{smi.splitlines()[0]}, {PAR_RANKS} ranks on one card "
                  f"over gloo", backend="gloo")
        lap("[parallel]")

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

    for run_phase in (phase_main, phase_gather, phase_qdemod, phase_bandfft,
                      phase_mixed,
                      phase_bands, phase_band, phase_dead, phase_paths96,
                      phase_nco, phase_firpilot, phase_exact, phase_ncopath,
                      phase_classes, phase_deadstep, phase_routes,
                      phase_graphs, phase_apps, phase_acceptance,
                      phase_config5, phase_parallel):
        run_phase()

    for name in ROUTE_ENTRIES:
        # An entry's launches are those of the first run that made any
        # (the main path for rfft_pow2), beside every run's own count.
        by_run = {label: counts[name] for label, counts in runs.items()}
        first = next(label for label, k in by_run.items() if k)
        kstats[name].update(launches_run=first, launches_by_run=by_run)
        launches[name] = by_run[first]
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kstats[name]}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The resident band with the feedback pilot loop: ``resident``'s loop on
the band of ``portbench/pilots.py`` (each station's own pilot offset and
phase), with three additions.

* The step is built with the configuration's ``pll`` (``"nco"``: the
  exact tail's feedback loop, K-NCO on the card, its state chained).
* The record holds K-NCO's launches a step over the window
  (``nco_launches_a_step``), from the port's launch counter, which
  counts under graph replay.
* A traced run also keeps K-NCO's device time a step over the profiled
  stretch (``nco_ms_a_step``, every launch of the kernel summed by name:
  the breakdown keeps only a top ten), and after that stretch, with the
  profiler stopped, runs ``TRACE_STEPS`` steps inside
  ``profiling.tracing()``, where the compiled step replays a graph whose
  spans are timing events, and keeps each span's time in each replay
  (``graph_stages``, from ``profiling.report()["stages"]``).

The record's other keys are ``resident``'s, under the same ``loop``
name, so that its readers read this loop too.
"""

from __future__ import annotations

import collections
import gc
import random
import statistics
import time
from typing import Dict, List

import torch

from portbench import pilots, signals
from portbench.loops.resident import (ENQUEUE_REPS, LEAD_IN_S, SAMPLE_STEPS,
                                      STAGE_REPS, TRACE_STEPS, WARMUP_STEPS,
                                      _event_ms, _graphed, _sync)
from portbench.trace import MARKER, Tracer

NCO_KERNEL = "nco_pll_kernel"   # K-NCO's name in csrc/nco_pll.cu
GRAPH_LEAD_IN = 3               # calls inside tracing() before its stretch:
                                # the first captures the traced graph


def kernel_seconds(events, name: str) -> float:
    """Device time of every kernel whose name holds ``name``, between
    the first and the last marker launch of ``portbench.trace`` (0 where
    the trace lacks them)."""
    dev = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                 for ev in events
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
    marks = [e for e in dev if MARKER in e[2]]
    if len(marks) < 2:
        return 0.0
    lo, hi = marks[0][1], marks[-1][0]
    us = sum(min(b, hi) - max(a, lo) for a, b, kernel in dev
             if name in kernel and b > lo and a < hi)
    return us * 1e-6


class KernelTracer(Tracer):
    """``Tracer`` that also sums one kernel's device time over the
    stretch (:attr:`kernel_s`)."""

    def __init__(self, device: torch.device, kernel: str):
        super().__init__(device)
        self.kernel = kernel
        self.kernel_s = 0.0

    def stop(self) -> Dict:
        summary = super().stop()
        self.kernel_s = kernel_seconds(self._prof.events(), self.kernel)
        return summary


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, clock0: float) -> Dict:
    from radiocore_tpu_torch.kernels import nco_pll
    from radiocore_tpu_torch.parallel import pipeline

    pool = pilots.band_pool(seed, config, traffic, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    c = int(config["stations"])
    step, state = pipeline.make_multi_station_step(
        int(config["band_rate"]),
        signals.offsets(config),
        int(config["station_rate"]), int(config["audio_rate"]),
        float(config["deemphasis_s"]), mode=config["mode"],
        extract_demod=config["extract_demod"],
        pll=config.get("pll", "analytic"), device=device)
    chunks = pool.shape[0]
    k = 0
    for _ in range(WARMUP_STEPS):
        _, state = step(pool[k % chunks], state)
        k += 1
    _sync(device)

    # The window, as resident's.
    rng = random.Random(seed)
    keep = SAMPLE_STEPS
    sample, last = [], collections.deque(maxlen=chunks)
    steps = 0
    launches0 = nco_pll.launches.count
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        p = k % chunks
        audio, state = step(pool[p], state)
        k += 1
        out = {"position": p, "audio": audio, **state}
        last.append(out)
        if steps < keep:
            sample.append(out)
        else:
            j = rng.randrange(steps + 1)
            if j < keep:
                sample[j] = out
        steps += 1
        if time.perf_counter() >= end:
            break
    _sync(device)
    t1 = time.perf_counter()
    record = {"loop": "resident", "stations": c, "steps": steps,
              "attempted": steps, "failed": 0,
              "setup_s": t0 - clock0, "window_s": t1 - t0,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                    if device.type == "cuda" else 0),
              "nco_launches_a_step":
                  (nco_pll.launches.count - launches0) / steps}
    outputs = list({id(o): o for o in sample + list(last)}.values())

    if trace:
        record.update(_per_layer(step, pool, state, k, device))
    del step, state, audio, out, sample, last
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["outputs"] = outputs
    record["pool"] = lambda: pool
    return record


def _per_layer(step, pool, state, k, device) -> Dict:
    """``resident``'s traced stretch, stage timings and enqueue time, with
    K-NCO's device time from the stretch; then the stretch inside
    ``profiling.tracing()``."""
    from radiocore_tpu_torch.runtime import profiling

    chunks = pool.shape[0]
    tracer = KernelTracer(device, NCO_KERNEL)
    tracer.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < LEAD_IN_S:
        _, state = step(pool[k % chunks], state)
        k += 1
        torch.cuda.synchronize(device)
    tracer.mark()
    for _ in range(TRACE_STEPS):
        with torch.profiler.record_function("portbench.step"):
            _, state = step(pool[k % chunks], state)
        k += 1
    tracer.mark()
    summary = tracer.stop()

    names = list(step.stages)
    f1, f2, f3 = step.stages.values()
    band = pool[k % chunks]
    x1 = f1(band)
    x2 = f2(x1)
    stage_ms = {name: _event_ms(_graphed(f, *args).replay, STAGE_REPS)
                for name, f, args in ((names[0], f1, (band,)),
                                      (names[1], f2, (x1,)),
                                      (names[2], f3, (x2, state)))}

    host = []
    for _ in range(ENQUEUE_REPS):
        torch.cuda.synchronize(device)
        h0 = time.perf_counter()
        step(band, state)
        host.append(time.perf_counter() - h0)
    torch.cuda.synchronize(device)

    # Each replay's span times: the newest capture's pair of each name.
    graph_stages: Dict[str, List[float]] = {}
    with profiling.tracing():
        for i in range(GRAPH_LEAD_IN + TRACE_STEPS):
            _, state = step(pool[k % chunks], state)
            k += 1
            if i < GRAPH_LEAD_IN:
                continue
            newest = {s.name: s.ms for s in profiling.report()["stages"]}
            for name, ms in newest.items():
                if ms is not None:
                    graph_stages.setdefault(name, []).append(ms)
    return {"trace": summary, "stage_ms": stage_ms,
            "enqueue_ms": 1e3 * statistics.fmean(host),
            "nco_ms_a_step": 1e3 * tracer.kernel_s / TRACE_STEPS,
            "graph_stages": graph_stages}

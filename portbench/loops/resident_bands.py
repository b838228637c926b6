"""Several bands resident on the card (``bands`` in the configuration:
SDRs side by side, each band with its own station plan): ``resident``'s
loop with every band stepped together by one compiled step a chunk.

* The pool is ``portbench/bands.band_pools``': a pool of chunks a band,
  made on the card from the seed; a step takes chunk p of every band,
  ``(bands, band_rate)``, and the step is built with each band's offsets
  (``make_multi_station_step(bands=...)``). Its audio and state hold
  every band's stations, band after band, as the reference
  ``references/multi_bands`` answers.
* The record holds the bands stepped a step (``bands_a_step``, from the
  port's counter ``pipeline.bands``) and K-GATHER's launches a step
  (``gather_launches_a_step``) over the window; both count under graph
  replay.
* A traced run keeps ``resident_pll``'s per-layer stretch with
  K-GATHER's device time a step over the profiled stretch
  (``gather_ms_a_step``) in place of K-NCO's, then ``TRACE_STEPS`` steps
  inside ``profiling.tracing()`` whose spans are kept a replay each
  (``graph_stages``).

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

from portbench import bands
from portbench.loops.resident import (ENQUEUE_REPS, LEAD_IN_S, SAMPLE_STEPS,
                                      STAGE_REPS, TRACE_STEPS, WARMUP_STEPS,
                                      _event_ms, _graphed, _sync)
from portbench.loops.resident_pll import GRAPH_LEAD_IN, KernelTracer

GATHER_KERNEL = "gather_kernel"   # K-GATHER's name in csrc/extract_gather.cu


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, clock0: float) -> Dict:
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.parallel import pipeline

    pool = bands.band_pools(seed, config, traffic, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    c = int(config["stations"])
    step, state = pipeline.make_multi_station_step(
        int(config["band_rate"]), None,
        int(config["station_rate"]), int(config["audio_rate"]),
        float(config["deemphasis_s"]), mode=config["mode"],
        extract_demod=config["extract_demod"],
        bands=bands.band_offsets(config), device=device)
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
    stepped0 = pipeline.bands.count
    gathered0 = extract.gather_launches.count
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
              "bands_a_step": (pipeline.bands.count - stepped0) / steps,
              "gather_launches_a_step":
                  (extract.gather_launches.count - gathered0) / steps}
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
    K-GATHER's device time from the stretch; then the stretch inside
    ``profiling.tracing()``, as ``resident_pll``'s."""
    from radiocore_tpu_torch.runtime import profiling

    chunks = pool.shape[0]
    tracer = KernelTracer(device, GATHER_KERNEL)
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
            "gather_ms_a_step": 1e3 * tracer.kernel_s / TRACE_STEPS,
            "graph_stages": graph_stages}

"""The band already on the card: the compiled multi-station step, back to
back, its state chained, over a pool of band chunks that cycles.

Closed loop with no host layer in the way: the rate is what the card
sustains. The pool is made on the card at set-up, larger than the L2
cache, so each chunk comes from device memory as a fresh SDR chunk
would. The audio stays on the card.
"""

from __future__ import annotations

import collections
import gc
import random
import statistics
import time
from typing import Dict

import torch

from portbench import signals
from portbench.trace import Tracer

WARMUP_STEPS = 8         # before the window: capture and settle
SAMPLE_STEPS = 4         # outputs of the window drawn from the seed
LEAD_IN_S = 0.1          # of untraced steps before the traced ones
TRACE_STEPS = 200        # traced after the lead-in
STAGE_REPS = 20          # CUDA-event timings of each stage's graph
ENQUEUE_REPS = 50        # host timings of one step call


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
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
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _graphed(fn, *args) -> torch.cuda.CUDAGraph:
    """``fn(*args)`` captured as one CUDA graph on these very arguments,
    after PyTorch's documented warm-up on a side stream. Replaying it
    times the stage's device work alone: eagerly, a stage of many small
    launches waits on the host between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn(*args)
    return graph


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: torch.device, clock0: float) -> Dict:
    from radiocore_tpu_torch.parallel import pipeline

    pool = signals.band_pool(seed, config, traffic, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    c = int(config["stations"])
    step, state = pipeline.make_multi_station_step(
        int(config["band_rate"]),
        signals.offsets(config),
        int(config["station_rate"]), int(config["audio_rate"]),
        float(config["deemphasis_s"]), mode=config["mode"],
        extract_demod=config["extract_demod"], device=device)
    chunks = pool.shape[0]
    k = 0
    for _ in range(WARMUP_STEPS):
        _, state = step(pool[k % chunks], state)
        k += 1
    _sync(device)

    # The window. Outputs stay referenced, not copied: the last of each
    # pool position and a sample drawn from the seed.
    rng = random.Random(seed)
    keep = SAMPLE_STEPS
    sample, last = [], collections.deque(maxlen=chunks)
    steps = 0
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
                                    if device.type == "cuda" else 0)}
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
    """After the window: a traced stretch of steps, each stage's device
    time (its eager body captured alone as a CUDA graph, as the step is
    captured whole), and the host's time to enqueue one step."""
    chunks = pool.shape[0]
    tracer = Tracer(device)
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

    reps = STAGE_REPS
    names = list(step.stages)
    f1, f2, f3 = step.stages.values()
    band = pool[k % chunks]
    x1 = f1(band)
    x2 = f2(x1)
    stage_ms = {name: _event_ms(_graphed(f, *args).replay, reps)
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
    return {"trace": summary, "stage_ms": stage_ms,
            "enqueue_ms": 1e3 * statistics.fmean(host)}

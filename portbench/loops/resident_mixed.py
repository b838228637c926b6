"""The resident band through a mix of demodulators: ``resident``'s loop
with the step built with the configuration's ``kinds`` (WBFM, MFM and FM
stations, one extraction grouped by kind and a batched tail a kind).

* The record holds each kind's stations demodulated a step over the
  window (``stations_a_step``), from the port's counters
  (``pipeline.demodulated``), which count under graph replay.
* A traced run adds ``resident_pll``'s per-layer stretch (its K-NCO
  time reads 0 here, and no metric of this cell reads it): the profiled
  steps, the stage-alone graphs and the enqueue time, then
  ``TRACE_STEPS`` steps inside ``profiling.tracing()`` whose spans
  (``tail_wbfm``, ``tail_mfm``, ``tail_fm`` among them) are kept a
  replay each (``graph_stages``).
* The step's outputs are dicts by kind; each kept output is laid out for
  ``harness.judge`` after the window as ``references/multi_mixed``
  answers (``multi_mixed.layout``: the kinds' audio flattened and
  joined, the WBFM and MFM histories).

The record's other keys are ``resident``'s, under the same ``loop``
name, so that its readers read this loop too.
"""

from __future__ import annotations

import collections
import gc
import random
import time
from typing import Dict

import torch

from portbench import signals
from portbench.loops import resident_pll
from portbench.loops.resident import SAMPLE_STEPS, WARMUP_STEPS, _sync
from portbench.references.multi_mixed import layout


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
        extract_demod=config["extract_demod"],
        pll=config.get("pll", "analytic"), kinds=config["kinds"],
        device=device)
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
    counted0 = {kind: n.count for kind, n in pipeline.demodulated.items()}
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        p = k % chunks
        audio, state = step(pool[p], state)
        k += 1
        out = {"position": p, "audio": audio, "state": state}
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
              "stations_a_step": {
                  kind: (n.count - counted0[kind]) / steps
                  for kind, n in pipeline.demodulated.items()}}
    kept = list({id(o): o for o in sample + list(last)}.values())

    if trace:
        record.update(resident_pll._per_layer(step, pool, state, k, device))
    del step, state, audio, out, sample, last
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["outputs"] = [_laid_out(o) for o in kept]
    record["pool"] = lambda: pool
    return record


def _laid_out(out: Dict) -> Dict:
    """One kept output in the reference's layout."""
    w, m = out["state"].get("wbfm"), out["state"].get("mfm")
    return {"position": out["position"],
            **layout(out["audio"], None if w is None else w["deemph_l"],
                     None if w is None else w["deemph_r"],
                     None if m is None else m["deemph"])}

"""One run of one cell: find its parts by name, drive the port, read the
metrics, judge the outputs against the plain reference.

Everything is found by the names in ``BENCHMARK.json``:

* a configuration: the JSON file its entry names (``configs[].file``);
* a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``"loop"``
  names the code that drives it, ``portbench/loops/<loop>.py``;
* a metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` returns
  the number from the run's record, or None where it finds nothing;
* the plain reference that decides ``correct``: the configuration's
  ``"reference"``, ``portbench/references/<reference>.py``.

A loop's record holds ``loop``, ``stations``, ``setup_s``, ``window_s``,
``attempted``, ``failed``, ``memory_peak_bytes``, ``outputs`` (dicts of
``position`` in the pool, ``audio`` (stations, audio, 2) and, where the
loop sees it, the state ``deemph_l``/``deemph_r``) and ``pool`` (a
function giving the band chunks back); ``steps`` (resident) or ``chunks``
and ``latencies_s`` (served); in a traced run ``trace`` (busy and window
seconds, breakdown) and the stage readings (``stage_ms``, ``enqueue_ms``,
``served``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

PKG = Path(__file__).resolve().parent
# Whole top-level module names that may not be loaded: JAX and the JAX
# package (the port's name, ``radiocore_tpu_torch``, only begins with it).
FORBIDDEN = ("jax", "jaxlib", "flax", "radiocore_tpu")


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r}")


def load_config(root: Path, bench: dict, name: str) -> dict:
    entry = find(bench["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(PKG / "traffic" / f"{name}.json") as f:
        return json.load(f)


def loop(name: str):
    return importlib.import_module(f"portbench.loops.{name}")


def reference(name: str):
    return importlib.import_module(f"portbench.references.{name}")


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``portbench/metrics/<name>.py`` (a metric's name may
    hold dots, so the file is loaded by its path)."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def max_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference; a NaN or an infinity anywhere reads as
    1e308, the largest gap JSON can carry."""
    d = (torch.as_tensor(got).to(device=want.device, dtype=want.dtype)
         - want).abs()
    if not bool(torch.isfinite(d).all()):
        return 1e308
    return float(d.max())


def judge(record: dict, config: dict, device: torch.device
          ) -> Dict[str, Dict[str, float]]:
    """Each number compared, with its limit: the widest gap between what
    the timed path produced and the reference's answer for the same pool
    position, over every output kept (audio, and the carried state where
    the loop sees it)."""
    pool = record.pop("pool")()
    answers = reference(config["reference"]).answers(config, pool, device)
    del pool
    gaps = {"audio_gap": 0.0}
    for out in record.pop("outputs"):
        want = answers[out["position"]]
        gaps["audio_gap"] = max(gaps["audio_gap"],
                                max_gap(out["audio"], want["audio"]))
        for leg in ("deemph_l", "deemph_r"):
            if leg in out:
                gaps["state_gap"] = max(
                    gaps.get("state_gap", 0.0),
                    max_gap(out[leg], want[leg]))
    limits = config["limits"]
    return {k: {"value": v, "limit": float(limits[k])}
            for k, v in gaps.items()}


def run_cell(root: Path, bench: dict, cell: str, seed: int, seconds: float,
             trace: bool, device: torch.device, clock0: float,
             config: Optional[dict] = None) -> dict:
    """One run; returns the result line's object (without the import
    check, which the caller makes once everything has run). ``config``
    replaces the cell's configuration (the CPU tests' small plans)."""
    work = find(bench["workloads"], cell, "workload")
    if config is None:
        config = load_config(root, bench, work["config"])
    traffic = load_traffic(work["traffic"])
    record = loop(traffic["loop"]).run(config, traffic, seed, seconds,
                                       trace, device, clock0)
    record["config"] = config
    record["device_name"] = (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu")
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge(record, config, device)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": record["device_name"], "count": 1,
           "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": metrics,
              "device": dev}
    if trace and "trace" in record:
        t = record["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    if record["failed"]:
        result["correct"] = False
    result["checks"] = checks
    return result


def check_lines(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            + ("" if c["value"] <= c["limit"] else "  FAILED")
            for k, c in checks.items()]

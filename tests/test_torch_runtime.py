"""The port's runtime layer against ``tests/test_runtime.py``'s cells:
metrics, stage timers, the config tree, the platform probe, the copies,
and the profiler trace, on the CPU."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from radiocore_tpu.runtime import config as jax_config
from radiocore_tpu.runtime.metrics import Metrics as JaxMetrics
from radiocore_tpu_torch import runtime
from radiocore_tpu_torch.runtime.config import (MeshConfig, PipelineConfig,
                                                StationConfig)
from radiocore_tpu_torch.runtime.metrics import Metrics
from radiocore_tpu_torch.runtime.profiling import (StageTimer, device_trace,
                                                   sync)
from radiocore_tpu_torch.runtime.transfer import to_device_c64, to_host

torch.set_num_threads(2)


def test_metrics_counters_and_gauges():
    m = Metrics()
    m.incr("chunks")
    m.incr("chunks", 2)
    m.gauge("occupancy", 0.5)
    snap = m.snapshot()
    assert snap["chunks"] == 3
    assert snap["occupancy"] == 0.5
    assert snap["uptime_s"] >= 0
    assert m.realtime_factor(100.0) > 0
    assert "chunks" in repr(m)


def test_metrics_snapshot_keys_match_jax():
    ms = (Metrics(), JaxMetrics())
    for m in ms:
        m.incr("a", 2.5)
        m.gauge("b", 7.0)
    mine, theirs = (m.snapshot() for m in ms)
    assert set(mine) == set(theirs)
    assert {k: v for k, v in mine.items() if k != "uptime_s"} == {
        k: v for k, v in theirs.items() if k != "uptime_s"}


def test_metrics_thread_safe():
    """Eight threads incrementing one counter lose no update."""
    import sys
    import threading

    m = Metrics()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [m.incr("n") for _ in range(2000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert m.snapshot()["n"] == 8 * 2000


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        time.sleep(0.01)
    with t.stage("a"):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2
    assert rep["a"]["total_s"] >= 0.01
    assert set(rep["a"]) == {"total_s", "count", "mean_ms"}
    assert "a:" in repr(t)


@pytest.mark.parametrize("shape", ["tensor", "tuple", "list", "dict",
                                   "nested", "host"])
def test_stage_timer_sync_values(shape):
    """``sync_value`` and ``sync`` take a tensor or a tuple, list or dict
    of them; CPU tensors and host values need no wait."""
    x = torch.ones(4)
    value = {"tensor": x, "tuple": (x, x), "list": [x], "dict": {"a": x},
             "nested": {"a": (x, [x])}, "host": np.ones(3)}[shape]
    t = StageTimer()
    with t.stage("s", sync_value=value):
        pass
    assert t.report()["s"]["count"] == 1
    assert t.sync(value) is value
    assert sync(value) is value


def test_device_trace_writes_chrome_trace(tmp_path):
    with device_trace(str(tmp_path)):
        torch.fft.fft(torch.ones(1024, dtype=torch.complex64))
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("fft" in str(ev.get("name", "")) for ev in events)


def test_pipeline_config_chunks():
    cfg = PipelineConfig(input_rate=10e6, demod_rate=250e3, audio_rate=48e3,
                         stations=(StationConfig(96.9e6),),
                         mesh=MeshConfig(stations=4, time=2))
    assert cfg.chunk_size == 10_000_000
    assert cfg.demod_chunk == 250_000
    assert cfg.audio_chunk == 48_000
    assert cfg.mesh.n_devices == 8
    hash(cfg)  # frozen → hashable


@pytest.mark.parametrize("kwargs", [
    {}, dict(input_rate=2.4e6, demod_rate=240e3, audio_rate=48e3),
    dict(input_rate=131072, demod_rate=65536, audio_rate=16384,
         chunk_seconds=0.5)])
def test_pipeline_config_matches_jax(kwargs):
    """The copy keeps the reference's fields, defaults and chunk sizes."""
    mine = PipelineConfig(**kwargs)
    theirs = jax_config.PipelineConfig(**kwargs)
    names = [f.name for f in dataclasses.fields(mine)]
    assert names == [f.name for f in dataclasses.fields(theirs)]
    for name in names:
        if name not in ("stations", "mesh"):
            assert getattr(mine, name) == getattr(theirs, name), name
    for prop in ("chunk_size", "demod_chunk", "audio_chunk"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert StationConfig(1e6) == StationConfig(1e6, 240e3, "wbfm")
    assert (StationConfig(1e6).bandwidth, StationConfig(1e6).mode) == (
        jax_config.StationConfig(1e6).bandwidth,
        jax_config.StationConfig(1e6).mode)


def test_platform_probe_cpu():
    assert runtime.has_cuda() is torch.cuda.is_available()
    assert runtime.HasCuda() is runtime.has_cuda()
    summary = runtime.platform_summary()
    if not summary["has_cuda"]:
        assert summary["platform"] == "cpu"
        assert summary["n_devices"] == 0


def test_runtime_exports():
    for name in ("has_cuda", "HasCuda", "platform_summary", "PipelineConfig",
                 "StationConfig", "MeshConfig", "Metrics", "save_state",
                 "load_state", "to_device_c64", "to_host"):
        assert name in runtime.__all__ and hasattr(runtime, name), name


def test_transfer_roundtrip():
    x = (np.arange(10) + 1j * np.arange(10)).astype(np.complex64)
    dev = to_device_c64(x, "cpu")
    np.testing.assert_array_equal(to_host(dev), x)
    r = to_device_c64(np.arange(4, dtype=np.float32), "cpu")
    assert r.dtype == torch.complex64
    # A tensor already on the device as complex64 is not copied.
    assert to_device_c64(dev, "cpu") is dev

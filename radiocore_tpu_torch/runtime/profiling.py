"""Tracing and profiling helpers; counterpart of
``radiocore_tpu/runtime/profiling.py``: a ``torch.profiler`` trace of a
block of code, and named-stage wall timers that wait on the device only
where asked.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, List

import torch

# torch.profiler can drop the first events of its window on the card: a
# window opens with this many milliseconds of small launches.
_LEAD_MS = 100.0


def _cuda_devices(value: Any) -> List[torch.device]:
    """The CUDA devices the tensors in ``value`` (a tensor, or a tuple,
    list or dict of them, nested) live on."""
    if isinstance(value, torch.Tensor):
        return [value.device] if value.is_cuda else []
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        found: List[torch.device] = []
        for item in value:
            found += [d for d in _cuda_devices(item) if d not in found]
        return found
    return []


def sync(value: Any) -> Any:
    """Wait until the device work behind ``value`` is done and return it:
    ``torch.cuda.synchronize`` on each CUDA device its tensors live on;
    nothing for CPU tensors, whose work is done when the call returns."""
    for device in _cuda_devices(value):
        torch.cuda.synchronize(device)
    return value


def _lead_in() -> None:
    """:data:`_LEAD_MS` of small launches on the card, waited on one by
    one."""
    x = torch.zeros(1024, device="cuda")
    t0 = time.perf_counter()
    while (time.perf_counter() - t0) * 1e3 < _LEAD_MS:
        x.add_(1.0)
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[Any]:
    """Trace everything inside the block with ``torch.profiler`` (CPU
    activity, and CUDA activity where there is a card) and write it as a
    Chrome trace into ``log_dir``; yields the profiler.

    Where there is a card the window opens with a lead-in of small
    launches before the block runs (see :data:`_LEAD_MS`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            _lead_in()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulating named-stage wall timers with device sync.

    ``with timer.stage("channelize"): ...`` times the block on the host's
    clock. Kernel launches return before the device has run them, so a
    stage measures its device work only where it waits for it: pass the
    stage's result as ``sync_value``, or call :meth:`sync` on it.
    """

    def __init__(self) -> None:
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None) -> Iterator[None]:
        """Time one named stage; wait on ``sync_value`` (a tensor, or a
        tuple, list or dict of them) before the clock stops, so that its
        device work is charged to this stage."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                sync(sync_value)
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def sync(self, value):
        """Wait on the device work behind ``value`` and return it."""
        return sync(value)

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per-stage ``{name: {total_s, count, mean_ms}}`` summary."""
        return {
            name: {"total_s": total,
                   "count": self._counts[name],
                   "mean_ms": 1e3 * total / self._counts[name]}
            for name, total in self._totals.items()
        }

    def __repr__(self) -> str:
        lines = [f"  {k}: {v['mean_ms']:.2f} ms × {v['count']}"
                 for k, v in sorted(self.report().items())]
        return "StageTimer(\n" + "\n".join(lines) + "\n)"

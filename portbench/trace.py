"""Device traces of a stretch of a run, read with ``torch.profiler``.

The profiler can drop what the card ran in the first milliseconds of its
window (seen on the H100 machine: the first of ten launches, thirty
0.06-ms launches), so a traced stretch opens with a lead-in of work that
is not read, and the stretch read lies between two launches of a marker
kernel (``torch.histc`` on one element, which the port never launches).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, List, Optional, Tuple

import torch

MARKER = "Histogram"     # in the name of histc's CUDA kernel
NAMED = "portbench."     # the harness's host ranges (record_function)
TOP = 10                 # entries of each list of the breakdown


class LostMarker(RuntimeError):
    """The trace lacks one of the two markers."""


class Tracer:
    """``start()``, work, ``mark()``, traced work, ``mark()``, ``stop()``.

    ``stop`` returns the stretch between the marks: ``busy_s`` (the union
    of every kernel, copy and set on the card), ``window_s``, and the
    breakdown (the device operations that took most time, the longest
    idle gaps named by what the host was doing)."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        self.device = device
        self._one = torch.ones(1, device=device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        # The marker's first launch loads its module (lazy loading), which
        # would stall the traced stretch's first step.
        self.mark()

    def start(self) -> None:
        torch.cuda.synchronize(self.device)
        with _quiet():
            self._prof.start()

    def mark(self) -> None:
        torch.histc(self._one, bins=1)

    def stop(self) -> Dict:
        torch.cuda.synchronize(self.device)
        with _quiet():
            self._prof.stop()
            events = self._prof.events()
        return summarize(events)


@contextlib.contextmanager
def _quiet():
    """Silence the profiler's "clears events at the end of each cycle"
    (a tracer runs one cycle): the run's last lines are its checks."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        yield


def _merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _host_activity(cpu: List[Tuple[float, float, str, bool]],
                   at: float) -> str:
    """The innermost host range around ``at``: a range the harness named
    if there is one, else the innermost operator, else ``host idle``."""
    best: Optional[Tuple[float, float, str, bool]] = None
    for ev in cpu:
        if ev[0] <= at < ev[1]:
            if (best is None or (ev[3], ev[0]) > (best[3], best[0])):
                best = ev
    return best[2] if best is not None else "host idle"


def summarize(events) -> Dict:
    """Busy time, window and breakdown of the stretch between the two
    marker launches in ``events`` (``torch.profiler`` function events)."""
    dev, cpu = [], []
    for ev in events:
        tr = ev.time_range
        named = ev.name.startswith(NAMED)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # A host range also shows on the device's timeline as an
            # annotation, which is no work of the card's.
            if not named:
                dev.append((tr.start, tr.end, ev.name))
        else:
            cpu.append((tr.start, tr.end, ev.name, named))
    dev.sort()
    marks = [e for e in dev if MARKER in e[2]]
    if len(marks) < 2:
        raise LostMarker(f"{len(marks)} marker launches in the trace")
    lo, hi = marks[0][1], marks[-1][0]
    inside = [(max(a, lo), min(b, hi), name) for a, b, name in dev
              if b > lo and a < hi and MARKER not in name]
    if not inside:
        raise LostMarker("no device work between the markers")
    busy = _merge([(a, b) for a, b, _ in inside])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for a, b, name in inside:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    edges = [lo] + [x for span in busy for x in span] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named_gaps = [[_host_activity(cpu, (a + b) / 2)[:200], (b - a) * 1e-6]
                  for a, b in gaps[:TOP]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "device_ops": [[name[:200], us * 1e-6] for name, us in ops],
            "idle_gaps": named_gaps}

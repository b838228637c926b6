"""Collective traffic of the port's sharded code; counterpart of
``radiocore_tpu/parallel/comm_analysis.py``.

Scaling efficiency is ``t_compute / (t_compute + exposed collective
time)``. The reference reads the bytes each device receives per step off
the compiled HLO; the port has no compiled program, so its collectives
count them as they run (``collectives.CollectiveBytes``, one per mesh),
by the same kind names and the same rule: the bytes of each call's
result. :func:`projected_efficiency` turns bytes into a worst-case
efficiency for a link rate that the caller measures or states: the
reference's default rate is a TPU interconnect figure, and the port has
none.
"""

from __future__ import annotations

from typing import Dict

from radiocore_tpu_torch.parallel.collectives import CollectiveBytes


def collective_bytes(counter: CollectiveBytes) -> Dict[str, int]:
    """Bytes this rank's collectives returned, by kind, since the
    counter's last reset: ``{kind: bytes, ..., "total": bytes}``, kinds
    with no bytes left out (``mesh.counter`` is a mesh's counter)."""
    out = {k: v for k, v in counter.bytes.items() if v}
    out["total"] = sum(out.values())
    return out


def projected_efficiency(t_compute_s: float, coll_bytes: int,
                         link_bytes_per_s: float) -> float:
    """Scaling efficiency if the collectives are fully exposed (the worst
    case: no overlap of compute and communication)."""
    t_coll = coll_bytes / link_bytes_per_s
    return t_compute_s / (t_compute_s + t_coll)

"""Distributed channel extraction: six-step band FFT, spectrum roll and
windowed per-channel extraction on each rank's block; counterpart of
``radiocore_tpu/parallel/channelize_sharded.py``.

No rank holds the whole band or its spectrum: three all-to-alls for the
FFT, two point-to-point shifts for the roll, a one-bin halo, and each
rank extracts its own channels. :func:`make_extract_body` returns the
per-rank body, so that callers can run their own sharded stages before
it on the same block (a halo overlap-save FIR, in the wideband form).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.channelize import extraction_plan
from radiocore_tpu_torch.ops.consts import HostConst
from radiocore_tpu_torch.parallel.collectives import Axis, ppermute
from radiocore_tpu_torch.parallel.fft_sharded import (_fourstep_local_blocks,
                                                      split_for_shards)
from radiocore_tpu_torch.runtime.routes import Routes


def roll_sharded(block: torch.Tensor, shift: int, n: int,
                 axis: Axis) -> torch.Tensor:
    """Global circular roll of a block-sharded flat array: rank d's
    output is ``x[(d·B + shift) % n : … + B]``. The shift cuts each block
    into at most two pieces bound for two neighbours: two permutations,
    one when the shift is a whole number of blocks, none when it is 0."""
    d = axis.size
    b = n // d
    q, r = divmod(int(shift) % n, b)
    if r == 0:
        if q == 0:
            return block
        return ppermute(block, [(e, (e - q) % d) for e in range(d)], axis)
    perm_hi = [(e, (e - q) % d) for e in range(d)]
    perm_lo = [(e, (e - q - 1) % d) for e in range(d)]
    high = ppermute(block[r:], perm_hi, axis)
    low = ppermute(block[:r], perm_lo, axis)
    return torch.cat([high, low])


def make_extract_body(n_band: int, shifts: Sequence[int], bandwidth: int,
                      n_devices: int, axis: Axis,
                      routes: Optional[Routes] = None
                      ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """Per-rank ``band block (n/D,) → channels (C/D, m)`` body, or None.

    Qualifies when the channel plan tiles the band uniformly and
    critically (``n = C·m``, spacing m), ``C % D == 0``, and an
    ``n = n1·n2`` split exists with both factors divisible by D. Channel
    c lives on rank ``c // (C/D)`` of ``axis``. The shift, window and
    Nyquist fold are those of ``ops.channelize.make_extractor``.
    """
    n = int(n_band)
    m = int(bandwidth)
    c = len(shifts)
    d = int(n_devices)
    starts, w_out, w_fix, m2, _run = extraction_plan(n, shifts, m)
    uniform = (c > 1 and all((starts[i] - starts[0]) % n == (i * m) % n
                             for i in range(c)))
    split = split_for_shards(n, d)
    if not (d > 1 and uniform and n == c * m and c % d == 0
            and split is not None):
        return None
    n1, n2 = split
    c_loc = c // d
    a0 = int(starts[0])
    neg = m - m2
    s_fac = n / m
    w_c = HostConst(w_out)
    fix = float(w_fix) if w_fix is not None else None

    def body(block: torch.Tensor) -> torch.Tensor:
        spec = _fourstep_local_blocks(block, n1, n2, axis,
                                      routes)               # my k block
        rolled = roll_sharded(spec, a0, n, axis)
        # One halo bin: the right neighbour's first rolled bin (wraps).
        halo = ppermute(rolled[:1], [(e, (e - 1) % d) for e in range(d)],
                        axis)
        rows = rolled.reshape(c_loc, m)
        nxt = torch.cat([rows[1:, :1], halo[None, :]], dim=0)
        w = w_c.on(block.device)
        # The reorder, window and fix of ops.channelize's uniform path.
        if m % 2 == 0:
            pos = torch.cat([rows[:, m // 2:], nxt], dim=-1)
            y = torch.cat([pos, rows[:, 1:m // 2]], dim=-1) * w
            y[:, m2 - 1] += rows[:, 0] * fix
        else:
            pos = torch.cat([rows[:, neg:], nxt], dim=-1)[:, :m2]
            y = torch.cat([pos, rows[:, :neg]], dim=-1) * w
        return _fft.ifft(y / s_fac, routes)                  # (c_loc, m)

    return body

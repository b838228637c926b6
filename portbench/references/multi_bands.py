"""The plain reference of the multi-band step (a configuration's
``"reference": "multi_bands"``): B bands of one rate, each with its own
station plan (``portbench/bands.py``), decoded in one step. Each band's
chain is ``multi_wbfm``'s, in float64, on that band's chunks and
offsets; the answers join the bands' rows band after band, as the port's
step orders them. It imports nothing of the port, of JAX or of the JAX
package.

``precision="bfloat16"`` is the control, as in ``multi_wbfm``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.bands import band_offsets, one_band
from portbench.references.multi_wbfm import (Reference, first_answer,
                                             pool_answers)


def band_references(config: dict, precision: str = "float64", *,
                    device: torch.device | str = "cpu") -> List[Reference]:
    """One ``multi_wbfm.Reference`` a band, on its own offsets."""
    refs = []
    for offsets in band_offsets(config):
        ref = Reference(one_band(config), precision, device=device)
        ref.offsets = offsets
        refs.append(ref)
    return refs


def _joined(per_band: List[Dict[str, torch.Tensor]]
            ) -> Dict[str, torch.Tensor]:
    return {key: torch.cat([a[key] for a in per_band])
            for key in per_band[0]}


def answers(config: dict, pool: torch.Tensor, device: torch.device
            ) -> List[Dict[str, torch.Tensor]]:
    """The harness's entry: for each position p of a pool ``(chunks, B,
    n)`` that cycles, what a step on it gives after a step on chunk
    p - 1, every band's rows joined."""
    per_band = [pool_answers(ref, pool[:, b]) for b, ref in
                enumerate(band_references(config, device=device))]
    return [_joined([a[p] for a in per_band]) for p in range(pool.shape[0])]


def first_answers(config: dict, bands: torch.Tensor,
                  device: torch.device | str = "cpu"
                  ) -> Dict[str, torch.Tensor]:
    """What a step from the initial state gives on ``bands (B, n)``."""
    return _joined([first_answer(ref, bands[b]) for b, ref in
                    enumerate(band_references(config, device=device))])


def control_step(config: dict, device: torch.device):
    """The control in the program's place: ``(step, state)`` shaped as
    the port's multi-band step gives them, each band by the bfloat16
    reference from the state it is handed."""
    refs = band_references(config, "bfloat16", device=device)

    def step(bands: torch.Tensor, state: Dict[str, torch.Tensor]):
        hist = torch.stack([state["deemph_l"], state["deemph_r"]], dim=1)
        audio, new, a = [], [], 0
        for b, ref in enumerate(refs):
            out, h = ref.finish(ref.legs(bands[b]), hist[a:a + ref.c])
            audio.append(out)
            new.append(h)
            a += ref.c
        audio, new = torch.cat(audio), torch.cat(new)
        return audio.float(), {"deemph_l": new[:, 0].float().contiguous(),
                               "deemph_r": new[:, 1].float().contiguous()}

    h = torch.cat([ref.initial_history() for ref in refs])
    return step, {"deemph_l": h[:, 0].clone(), "deemph_r": h[:, 1].clone()}

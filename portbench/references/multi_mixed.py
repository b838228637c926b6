"""The plain reference of the multi-station step over a mix of
demodulators (a configuration's ``"reference": "multi_mixed"``): what
the port's ``make_multi_station_step(kinds=...)`` computes, written again
from the published math in plain PyTorch and SciPy, in float64. It
imports nothing of the port, of JAX or of the JAX package, and is handed
only the band chunks the harness made.

The configuration's ``"kinds"`` gives each station's demodulator, in
station order, as the upstream server's ``examples/multi_fm_server.py``
registers a ``WBFM``, ``MFM`` or ``FM`` per channel. Steps 1 to 3 (the
band's DFT, each station's bins, the quadrature demod ``angle(x[t]
conj(x[t-1])) / pi``) are ``multi_wbfm``'s for every station. Then, by
kind:

* ``wbfm``: ``multi_wbfm``'s stereo decoder of the configuration's mode,
  its de-emphasis with both legs' histories carried, the mean of both
  legs removed, a clip at 0.999;
* ``fm`` (upstream ``analog/fm.py:60-67``): the demod decimated to the
  audio rate through the Hamming spectral window, ``multi_wbfm``'s
  ``_decimate``;
* ``mfm`` (upstream ``analog/mfm.py:62-66``): ``fm``, then the 51-tap
  de-emphasis of the 75 us pole with its 50 last inputs carried to the
  next chunk (ones at the start), the chunk's mean subtracted, a clip at
  0.999.

An answer is laid out as ``portbench/loops/resident_mixed.py`` lays out
the port's outputs, so that ``harness.judge`` compares every output and
every carried history: ``audio`` the WBFM audio ``(C_w, m, 2)``, the MFM
audio ``(C_m, m)`` and the FM audio ``(C_f, m)``, each flattened, joined
in that order; ``deemph_l`` the WBFM left histories followed by the MFM
histories; ``deemph_r`` the WBFM right histories (a key whose rows would
be empty is left out).

``precision="bfloat16"`` is the control, as in ``multi_wbfm``: the same
chain in float32 with every stage's output rounded to bfloat16. It must
fail the comparison.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.references import multi_wbfm
from portbench.references.multi_wbfm import BLOCK, CLIP, DEEMPH_TAPS

KINDS = ("wbfm", "mfm", "fm")   # the groups, in the layout's order
HIST = DEEMPH_TAPS - 1


class Reference(multi_wbfm.Reference):
    """``multi_wbfm``'s chain for one configuration of a mix, its
    stations taken group by group (``rows``)."""

    def __init__(self, config: dict, precision: str = "float64", *,
                 device: torch.device | str = "cpu"):
        super().__init__(config, precision, device=device)
        kinds = list(config["kinds"])
        if len(kinds) != self.c or set(kinds) - set(KINDS):
            raise ValueError(f"kinds {kinds}: {self.c} of {KINDS} wanted")
        self.rows = {k: [i for i, x in enumerate(kinds) if x == k]
                     for k in KINDS}
        # ``stations`` takes its offsets in this order: the groups' rows.
        self.offsets = [self.offsets[i] for k in KINDS for i in self.rows[k]]

    def groups(self, band: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Steps 1 to 4 of one chunk by kind: the WBFM legs before the
        de-emphasis ``(C_w, 2, m)``, the MFM and FM demod decimated to the
        audio rate ``(C, m)``."""
        spec = self.spectrum(band)
        out, a = {}, 0
        for kind in KINDS:
            end = a + len(self.rows[kind])
            parts = []
            for b in range(a, end, BLOCK):
                quad = self.demod(self.stations(spec, slice(b, min(
                    b + BLOCK, end))))
                if kind != "wbfm":
                    parts.append(self.fm(quad))
                elif self.mode == "fast":
                    parts.append(self._fast(quad))
                else:
                    parts.append(self._exact(quad))
            out[kind] = torch.cat(parts) if parts else None
            a = end
        return out

    def fm(self, quad: torch.Tensor) -> torch.Tensor:
        """The FM demodulator's output from the demod: ``(rows, m)``."""
        return self._decimate(self.q(torch.fft.rfft(quad)))

    def finish_mono(self, x: torch.Tensor, hist: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """MFM's end: ``(audio (rows, m), history (rows, 50))`` from the
        decimated demod and the previous chunk's history."""
        y = self.q(self._fir(x, self.de, hist.to(x.dtype)))
        y = torch.clamp(y - y.mean(dim=-1, keepdim=True), -CLIP, CLIP)
        return self.q(y), x[..., -HIST:]

    def chunk(self, now: Dict[str, torch.Tensor],
              hist: Dict[str, torch.Tensor]
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """One chunk's audio by kind and the histories it leaves, from its
        :meth:`groups` and the histories before it (``wbfm`` ``(C_w, 2,
        50)``, ``mfm`` ``(C_m, 50)``)."""
        audio, new = {}, {}
        if now["wbfm"] is not None:
            audio["wbfm"], new["wbfm"] = self.finish(now["wbfm"],
                                                     hist["wbfm"])
        if now["mfm"] is not None:
            audio["mfm"], new["mfm"] = self.finish_mono(now["mfm"],
                                                        hist["mfm"])
        if now["fm"] is not None:
            audio["fm"] = self.q(now["fm"])
        return audio, new

    def initial_histories(self) -> Dict[str, torch.Tensor]:
        ones = dict(dtype=self.real, device=self.device)
        return {"wbfm": torch.ones(len(self.rows["wbfm"]), 2, HIST, **ones),
                "mfm": torch.ones(len(self.rows["mfm"]), HIST, **ones)}


def layout(audio: Dict[str, torch.Tensor],
           wbfm_l: torch.Tensor | None, wbfm_r: torch.Tensor | None,
           mfm: torch.Tensor | None) -> Dict[str, torch.Tensor]:
    """The answer's layout (module docstring) from audio by kind and the
    carried histories (None where the kind is absent)."""
    out = {"audio": torch.cat([audio[k].reshape(-1) for k in KINDS
                               if k in audio])}
    left = [h for h in (wbfm_l, mfm) if h is not None and h.numel()]
    if left:
        out["deemph_l"] = torch.cat(left)
    if wbfm_r is not None and wbfm_r.numel():
        out["deemph_r"] = wbfm_r
    return out


def pool_answers(ref: Reference, pool: torch.Tensor
                 ) -> List[Dict[str, torch.Tensor]]:
    """For each chunk ``p`` of a pool that cycles, what a step on it gives
    after a step on chunk ``p - 1``, laid out (module docstring)."""
    groups = [ref.groups(pool[p]) for p in range(pool.shape[0])]
    out = []
    for p, now in enumerate(groups):
        before = groups[p - 1]
        hist = {k: before[k][..., -HIST:] for k in ("wbfm", "mfm")
                if before[k] is not None}
        audio, new = ref.chunk(now, hist)
        w = new.get("wbfm")
        out.append(layout(audio, None if w is None else w[:, 0],
                          None if w is None else w[:, 1], new.get("mfm")))
    return out


def answers(config: dict, pool: torch.Tensor, device: torch.device
            ) -> List[Dict[str, torch.Tensor]]:
    """The harness's entry: the float64 answers for each position of a
    pool that cycles (:func:`pool_answers`)."""
    return pool_answers(Reference(config, "float64", device=device), pool)


def control_step(config: dict, device: torch.device):
    """The control in the program's place: ``(step, state)`` shaped as
    the port's ``make_multi_station_step(kinds=...)`` gives them (audio and
    state by kind), computing each chunk by the bfloat16 reference from
    the histories the state carries."""
    ref = Reference(config, "bfloat16", device=device)

    def step(band: torch.Tensor, state: Dict[str, Dict[str, torch.Tensor]]):
        hist = {}
        if "wbfm" in state:
            w = state["wbfm"]
            hist["wbfm"] = torch.stack([w["deemph_l"], w["deemph_r"]], dim=1)
        if "mfm" in state:
            hist["mfm"] = state["mfm"]["deemph"]
        audio, new = ref.chunk(ref.groups(band), hist)
        out = {}
        if "wbfm" in new:
            out["wbfm"] = {"deemph_l": new["wbfm"][:, 0].float().contiguous(),
                           "deemph_r": new["wbfm"][:, 1].float().contiguous()}
        if "mfm" in new:
            out["mfm"] = {"deemph": new["mfm"].float().contiguous()}
        return {k: a.float() for k, a in audio.items()}, out

    h = ref.initial_histories()
    state = {}
    if ref.rows["wbfm"]:
        state["wbfm"] = {"deemph_l": h["wbfm"][:, 0].clone(),
                         "deemph_r": h["wbfm"][:, 1].clone()}
    if ref.rows["mfm"]:
        state["mfm"] = {"deemph": h["mfm"].clone()}
    return step, state

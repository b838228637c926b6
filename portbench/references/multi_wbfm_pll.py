"""The plain reference of the multi-station WBFM step with the feedback
pilot loop (a configuration's ``"reference": "multi_wbfm_pll"``): what
the port's ``make_multi_station_step(mode="exact", pll="nco")``
computes, written again from the published math in plain PyTorch, NumPy
and SciPy, in float64. It imports nothing of the port, of JAX or of the
JAX package, and is handed only the band chunks the harness made.

The chain is ``multi_wbfm``'s exact one (band DFT, extraction, quadrature
demod, the composite resampled to its own rate, the 19 kHz pilot by the
41-tap zero-phase bandpass) up to the pilot. Then, where ``multi_wbfm``
squares the pilot's analytic signal, each chunk's pilot is divided by its
RMS over the chunk and tracked by a second-order loop, the textbook
phase detector, PI loop filter and NCO:

    err = x[t] cos(phi);  traj[t] = phi;  freq += ki err
    phi += w0 + freq + kp err;  phi -= 2 pi where phi > pi

with ``w0 = 2 pi 19 kHz / fs`` and the standard normalized gains of a
loop of noise bandwidth ``B`` and damping ``zeta`` (``b = B / fs``):
``kp = 4 zeta b / d``, ``ki = 4 b^2 / d``, ``d = 1 + 2 zeta b + b^2``. The
38 kHz subcarrier is ``-sin(2 traj)``: for a pilot ``sin(theta)`` the
loop locks at ``phi = theta``, and the stereo encoder's subcarrier is
``sin(2 theta)``, taken with the sign of ``multi_wbfm``'s
``Im(a^2) / |a^2|`` for the analytic pilot ``a = -j e^{j theta}``. The
stereo matrix, the resampling to the audio rate and the de-emphasis are
``multi_wbfm``'s.

The loop's state is carried from chunk to chunk, so an answer depends on
what came before it. The answer at pool position ``p`` is the chain run
over position ``p - 1`` from the initial state (phase and frequency 0)
as a lead-in, then over ``p``; the de-emphasis history is the end of
position ``p - 1``'s legs as run after its own lead-in over ``p - 2``
(a chunk's legs depend on its first samples too, through the circular
resampling, so the history must come from a locked loop as well). Once
started, the loop forgets where it started within about half a second:
run over the same chunk from phase 0 and from phase pi/2 (or from phase
-3 with a frequency offset of 1e-4 rad a sample), at the configurations'
widths (240 kS/s, 4 stations' pilots of the ``resident_pll`` mix, two
seeds), the trajectories agree within 1e-6 rad after 0.29-0.31 s, 1e-9
rad after 0.43-0.45 s and 1e-12 rad after 0.56-0.59 s, so a one-second
lead-in leaves no trace of its start.

The loop runs on the CPU in NumPy, one iteration a sample with the
stations of every position as the vector; everything else runs on the
harness's device.

``precision="bfloat16"`` is the control, as in ``multi_wbfm``: the same
chain in float32 with every stage's output rounded to bfloat16 (the loop's
input and its phase trajectory included). It must fail the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.references import multi_wbfm

TWO_PI = 2.0 * math.pi
PILOT_HZ = 19e3


def loop_gains(fs: float, f0: float, loop_bw_hz: float, damping: float
               ) -> Tuple[float, float, float]:
    """``(kp, ki, w0)`` of the loop (module docstring)."""
    b = loop_bw_hz / fs
    d = 1.0 + 2.0 * damping * b + b * b
    return 4.0 * damping * b / d, 4.0 * b * b / d, TWO_PI * f0 / fs


def track(x: np.ndarray, gains: Tuple[float, float, float],
          phase: np.ndarray, freq: np.ndarray
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The loop over the last axis of ``x`` ``(rows, n)``, from ``phase``
    and ``freq`` ``(rows,)``, in ``x``'s dtype. Returns the trajectory
    ``(rows, n)`` (the phase each sample's detector saw) and the end
    state."""
    dt = x.dtype
    kp, ki, w0 = (dt.type(g) for g in gains)
    pi, two_pi = dt.type(math.pi), dt.type(TWO_PI)
    xs = np.ascontiguousarray(x.T)
    traj = np.empty_like(xs)
    ph = phase.astype(dt, copy=True)
    fr = freq.astype(dt, copy=True)
    err = np.empty_like(ph)
    tmp = np.empty_like(ph)
    wrap = np.empty(ph.shape, dtype=bool)
    for t in range(xs.shape[0]):
        traj[t] = ph
        np.cos(ph, out=err)
        err *= xs[t]
        np.multiply(err, ki, out=tmp)
        fr += tmp
        ph += w0
        ph += fr
        np.multiply(err, kp, out=tmp)
        ph += tmp
        np.greater(ph, pi, out=wrap)
        np.subtract(ph, two_pi, out=ph, where=wrap)
    return np.ascontiguousarray(traj.T), ph, fr


class Reference(multi_wbfm.Reference):
    """The chain with the feedback loop for one configuration, on
    ``device``; the loop on the CPU."""

    def __init__(self, config: dict, precision: str = "float64", *,
                 device: torch.device | str = "cpu"):
        if config["mode"] != "exact" or config.get("pll") != "nco":
            raise ValueError(f"multi_wbfm_pll takes mode 'exact' with pll "
                             f"'nco'; got {config['mode']!r}, "
                             f"{config.get('pll')!r}")
        super().__init__(config, precision, device=device)
        self.gains = loop_gains(self.sc, PILOT_HZ,
                                float(config["pll_loop_bw_hz"]),
                                float(config["pll_damping"]))
        self.np_real = np.float32 if self.low else np.float64

    def front(self, band: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk up to the loop: the composite and the pilot divided
        by its RMS, ``(c, n)`` each."""
        spec = self.spectrum(band)
        comps, pilots = [], []
        for b in range(0, self.c, multi_wbfm.BLOCK):
            rows = slice(b, b + multi_wbfm.BLOCK)
            quad = self.demod(self.stations(spec, rows))
            comp = self.q(torch.fft.irfft(torch.fft.rfft(quad) * self.w1_t,
                                          self.sc))
            pilot = self.q(self._filtfilt(comp))
            rms = torch.sqrt(torch.mean(pilot * pilot, dim=-1, keepdim=True))
            comps.append(comp)
            pilots.append(self.q(pilot / torch.clamp_min(
                rms, torch.finfo(self.real).tiny)))
        return torch.cat(comps), torch.cat(pilots)

    def track(self, pilots: torch.Tensor, phase: np.ndarray,
              freq: np.ndarray) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """The loop over ``pilots`` ``(rows, n)`` on the CPU; the
        trajectory comes back to the reference's device."""
        x = pilots.detach().to("cpu").numpy().astype(self.np_real)
        traj, ph, fr = track(x, self.gains, phase, freq)
        return self.q(torch.as_tensor(traj, device=self.device)), ph, fr

    def tail(self, comp: torch.Tensor, traj: torch.Tensor) -> torch.Tensor:
        """From the composite and the loop's trajectory to both legs
        before the de-emphasis, ``(c, 2, m)``."""
        sub = -torch.sin(2.0 * traj)
        lmr = self.q(sub * comp * multi_wbfm.STEREO_GAIN)
        legs = torch.stack([comp + lmr, comp - lmr], dim=1)
        return self._decimate(self.q(torch.fft.rfft(legs)))

    def initial_loop(self, rows: int) -> Tuple[np.ndarray, np.ndarray]:
        zeros = np.zeros(rows, dtype=self.np_real)
        return zeros, zeros.copy()


def pool_answers(ref: Reference, pool: torch.Tensor
                 ) -> List[Dict[str, torch.Tensor]]:
    """For each chunk ``p`` of a pool that cycles, what a locked step on
    it gives after a locked step on chunk ``p - 1`` (module docstring):
    ``{"audio": (c, m, 2), "deemph_l": (c, 50), "deemph_r": (c, 50)}``
    on the reference's device. Every position's lead-in runs in one pass
    of the loop, and every position after it in a second."""
    chunks, c = pool.shape[0], ref.c
    fronts = [ref.front(pool[p]) for p in range(chunks)]
    pilots = torch.cat([f[1] for f in fronts])
    _, ph, fr = ref.track(pilots, *ref.initial_loop(chunks * c))
    # Position p starts where the lead-in over p - 1 ended.
    start = [np.roll(s.reshape(chunks, c), 1, axis=0).reshape(-1)
             for s in (ph, fr)]
    traj, _, _ = ref.track(pilots, *start)
    del pilots
    legs = [ref.tail(fronts[p][0], traj[p * c:(p + 1) * c])
            for p in range(chunks)]
    del fronts, traj
    out = []
    for p in range(chunks):
        hist = legs[p - 1][..., -(multi_wbfm.DEEMPH_TAPS - 1):]
        audio, new = ref.finish(legs[p], hist)
        out.append({"audio": audio, "deemph_l": new[:, 0],
                    "deemph_r": new[:, 1]})
    return out


def answers(config: dict, pool: torch.Tensor, device: torch.device
            ) -> List[Dict[str, torch.Tensor]]:
    """The harness's entry: the float64 answers for each position of a
    pool that cycles (:func:`pool_answers`)."""
    return pool_answers(Reference(config, "float64", device=device), pool)


def control_step(config: dict, device: torch.device):
    """The control in the program's place: ``(step, state)`` shaped as
    the port's ``make_multi_station_step`` gives them, computing each
    chunk by the bfloat16 reference from the state it is given (the loop's
    phase and frequency under ``"pll"``)."""
    ref = Reference(config, "bfloat16", device=device)

    def step(band: torch.Tensor, state: Dict):
        comp, pilots = ref.front(band)
        ph, fr = (s.detach().to("cpu").numpy() for s in state["pll"])
        traj, ph, fr = ref.track(pilots, ph, fr)
        hist = torch.stack([state["deemph_l"], state["deemph_r"]], dim=1)
        audio, new = ref.finish(ref.tail(comp, traj), hist)
        loop = tuple(torch.as_tensor(s, device=device) for s in (ph, fr))
        return audio.float(), {"deemph_l": new[:, 0].float().contiguous(),
                               "deemph_r": new[:, 1].float().contiguous(),
                               "pll": loop}

    h = ref.initial_history()
    loop = tuple(torch.as_tensor(s, device=device)
                 for s in ref.initial_loop(ref.c))
    return step, {"deemph_l": h[:, 0].clone(), "deemph_r": h[:, 1].clone(),
                  "pll": loop}

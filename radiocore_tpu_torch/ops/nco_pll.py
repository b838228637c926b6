"""True feedback NCO phase-locked loop for the 19 kHz stereo pilot;
counterpart of ``radiocore_tpu/ops/nco_pll.py``.

The classic 2nd-order loop (phase detector → PI loop filter → NCO) as the
accuracy-mode alternative to the analytic-signal pilot tracker: carrier
tracking with a controlled loop bandwidth, its state streaming across
chunks. The recurrence is sequential per station; on a CUDA tensor it
runs as the kernel K-NCO (``kernels/nco_pll.py``), which carries the NCO
as a phasor (no phase on the per-sample chain), on the CPU as that
module's plain loops. :func:`nco_pll_track` returns the phase trajectory
(on the CPU the scan's own order; on a card the kernel's phase output);
:func:`nco_pll_subcarrier`, for the stereo decoder, the subcarrier alone.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels import nco_pll as knco


class PLLState(NamedTuple):
    phase: torch.Tensor     # NCO phase, radians
    freq: torch.Tensor      # integrator: freq offset, rad/sample


class PLLGains(NamedTuple):
    kp: float
    ki: float
    w0: float               # nominal pilot frequency, rad/sample


def pll_design(fs: float, f0: float = 19e3, loop_bw_hz: float = 50.0,
               damping: float = 0.7071) -> PLLGains:
    """PI gains for a 2nd-order loop (standard normalized design)."""
    bnt = loop_bw_hz / fs
    denom = 1.0 + 2.0 * damping * bnt + bnt * bnt
    kp = 4.0 * damping * bnt / denom
    ki = 4.0 * bnt * bnt / denom
    return PLLGains(kp=float(kp), ki=float(ki),
                    w0=float(2.0 * np.pi * f0 / fs))


def pll_init(batch_shape: Tuple[int, ...] = (), *,
             device: torch.device | str) -> PLLState:
    """Initial loop state (phase, frequency) per station."""
    zeros = torch.zeros(tuple(batch_shape), dtype=torch.float32,
                        device=device)
    return PLLState(phase=zeros, freq=zeros.clone())


def nco_pll_track(pilot: torch.Tensor, gains: PLLGains,
                  state: PLLState) -> Tuple[torch.Tensor, PLLState]:
    """Track the pilot; returns (phase trajectory, new state).

    ``pilot`` (..., N) float32 — normalize its amplitude beforehand (e.g.
    the bandpassed pilot divided by its RMS) so the loop gains hold.
    Phase detector: ``e[n] = pilot[n] · cos(φ[n])``; the trajectory holds
    the phase the detector saw for each sample. On the CPU the loop in
    the scan's order; on a CUDA tensor K-NCO's phase output, which
    rounds otherwise (the phasor's ``atan2`` after the first sample, the
    phase given).
    """
    kp, ki, w0 = gains
    traj, phase, freq = knco.nco_pll_track_rows(
        pilot.to(torch.float32), kp, ki, w0, state.phase, state.freq)
    return traj, PLLState(phase=phase, freq=freq)


def nco_pll_subcarrier(pilot: torch.Tensor, gains: PLLGains,
                       state: PLLState) -> Tuple[torch.Tensor, PLLState]:
    """Track the pilot and return the 38 kHz subcarrier it gives, with the
    new state: what ``pll_subcarrier(nco_pll_track(pilot / rms, ...)[0],
    2, "imag")`` gives, by the phasor form of the loop.

    ``pilot`` (..., N) float32 as the bandpass gives it: each row is
    scaled by 1 / its RMS over the chunk (floored at float32's ``tiny``)
    inside the loop, so the gains hold. The result is ``−sin(2 φ[n])``
    for the phase ``φ[n]`` the detector saw (the convention of
    :func:`pll_subcarrier`); the state carries the phase, as
    :func:`nco_pll_track`'s does. On a CUDA tensor the phasor kernel,
    on the CPU its plain loop (``kernels/nco_pll.py``).
    """
    kp, ki, w0 = gains
    pilot = pilot.to(torch.float32)
    rms = torch.sqrt(torch.mean(pilot * pilot, dim=-1))
    scale = torch.reciprocal(torch.clamp_min(
        rms, torch.finfo(torch.float32).tiny))
    sub, phase, freq = knco.nco_pll_subcarrier_rows(
        pilot, scale, kp, ki, w0, state.phase, state.freq)
    return sub, PLLState(phase=phase, freq=freq)


def pll_subcarrier(phase_traj: torch.Tensor, mult: int = 2,
                   part: str = "imag") -> torch.Tensor:
    """Unit-amplitude harmonic of the tracked phase, in the convention of
    :func:`~radiocore_tpu_torch.ops.analytic.pll_harmonic`: for a pilot
    ``sin(θ)``, ``imag`` gives ``−sin(m·θ)`` and ``real`` ``−cos(m·θ)``."""
    m_theta = mult * phase_traj
    if part == "real":
        return -torch.cos(m_theta)
    return -torch.sin(m_theta)

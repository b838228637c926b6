"""K-NCO: the feedback NCO phase-locked loop as one kernel launch.

Counterpart of the ``lax.scan`` in ``radiocore_tpu/ops/nco_pll.py``
(``nco_pll_track``): per row (station) a sequential loop over the
samples that carries ``(phase, freq)``,

    err = x[t]·cos(phase);  traj[t] = phase;  freq += ki·err
    phase = ((phase + w0) + freq) + kp·err;  phase −= 2π where phase > π

:func:`nco_pll_track_plain` is that loop in PyTorch, in the scan's order
and float32, with the rows as the vector, one Python iteration per
sample. The kernel (``csrc/nco_pll.cu``) gives a row to a thread, walks
it in tiles of :data:`TILE` samples and computes the same function with
the frequency update substituted into the phase update, so that one
sample's dependent chain is the hardware cosine and one fused
multiply-add (``p`` the phase before its wrap)::

    s = (wrap(p) + w0) + f;  c = cos(p)
    p' = fma((ki + kp)·x, c, s);  f' = fma(ki·x, c, f);  traj[t] = wrap(p)

It rounds differently from the scan: the two drift apart by about 1e-5
rad before the loop pulls them back, and the kernel's cosine (``__cosf``;
``cosf`` beyond 2π) is within 2^-21.41 of the exact one on [−π, π].

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain loop. :func:`nco_chain_probe` times the bare chain on the card, the
kernel's least time a sample; no path calls it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from radiocore_tpu_torch.kernels.fft_rows import LaunchCounter

# Samples a thread takes at once (csrc/nco_pll.cu kNcoTile), by 16-byte
# accesses on a 16-byte boundary, else by scalar ones; the ragged end goes
# sample by sample.
TILE = 48

# The chains rc_nco_chain_probe times (csrc/nco_pll.cu
# nco_chain_probe_kernel): the bare chain, FMUL -> MUFU.COS -> FFMA; the
# same with the wrap before the cosine; the kernel's whole sample without
# its loads and stores.
PROBE_CHAINS = ("bare", "wrap", "sample")

launches = LaunchCounter()

Result = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def nco_pll_track_plain(pilot: torch.Tensor, kp: float, ki: float, w0: float,
                        phase: torch.Tensor, freq: torch.Tensor) -> Result:
    """Plain version: a Python loop over the last axis of ``pilot``
    ``(..., n)``, the leading axes as the vector. Returns the phase
    trajectory ``(..., n)`` and the new ``phase`` and ``freq`` ``(...)``.
    Every product and sum is an operation of its own, in the scan's
    order, so that no device contracts them."""
    xs = pilot.to(torch.float32).movedim(-1, 0).contiguous()
    phase = phase.to(torch.float32).clone()
    freq = freq.to(torch.float32).clone()
    traj = torch.empty_like(xs)
    err = torch.empty_like(phase)
    tmp = torch.empty_like(phase)
    for t in range(xs.shape[0]):
        traj[t] = phase
        torch.cos(phase, out=err)
        err.mul_(xs[t])
        torch.mul(err, ki, out=tmp)
        freq.add_(tmp)
        phase.add_(w0).add_(freq)
        torch.mul(err, kp, out=tmp)
        phase.add_(tmp)
        phase = torch.where(phase > math.pi, phase - 2 * math.pi, phase)
    return traj.movedim(0, -1), phase, freq


def _nco_kernel(pilot: torch.Tensor, kp: float, ki: float, w0: float,
                phase: torch.Tensor, freq: torch.Tensor) -> Result:
    from radiocore_tpu_torch.kernels import build
    if pilot.dtype != torch.float32:
        raise TypeError(f"nco_pll_track_rows: kernel takes float32, got "
                        f"{pilot.dtype}")
    lead = tuple(pilot.shape[:-1])
    n = int(pilot.shape[-1])
    for name, s in (("phase", phase), ("freq", freq)):
        if (not s.is_cuda or s.dtype != torch.float32
                or tuple(s.shape) != lead):
            raise ValueError(
                f"nco_pll_track_rows: {name} must be float32 CUDA of shape "
                f"{lead}, got {s.dtype} {tuple(s.shape)} on {s.device}")
    if n < 1 or pilot.numel() == 0:
        raise ValueError(f"nco_pll_track_rows: empty pilot "
                         f"{tuple(pilot.shape)}")
    x2 = pilot.reshape(-1, n)
    if x2.stride(-1) != 1 and n > 1:
        raise ValueError("nco_pll_track_rows: pilot needs unit stride along "
                         "its last axis")
    rows = x2.shape[0]
    p_in = phase.reshape(-1).contiguous()
    f_in = freq.reshape(-1).contiguous()
    traj = torch.empty((rows, n), dtype=torch.float32, device=pilot.device)
    p_out = torch.empty_like(p_in)
    f_out = torch.empty_like(f_in)
    lib = build.library()
    err = lib.rc_nco_pll(x2.data_ptr(), x2.stride(0), p_in.data_ptr(),
                         f_in.data_ptr(), traj.data_ptr(), p_out.data_ptr(),
                         f_out.data_ptr(), rows, n, kp, ki, w0,
                         torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_nco_pll(rows={rows}, n={n})")
    launches.count += 1
    return traj.reshape(pilot.shape), p_out.reshape(lead), f_out.reshape(lead)


def nco_pll_track_rows(pilot: torch.Tensor, kp: float, ki: float, w0: float,
                       phase: torch.Tensor, freq: torch.Tensor) -> Result:
    """The loop along the last axis of ``pilot`` with any leading batch
    dims: the kernel on CUDA, :func:`nco_pll_track_plain` on the CPU."""
    kp, ki, w0 = float(kp), float(ki), float(w0)
    if pilot.is_cuda:
        return _nco_kernel(pilot, kp, ki, w0, phase, freq)
    if pilot.device.type != "cpu":
        raise ValueError(f"nco_pll_track_rows: no kernel for {pilot.device}")
    return nco_pll_track_plain(pilot, kp, ki, w0, phase, freq)


def nco_chain_probe(n: int, chain: str, lanes: int, kp: float, ki: float,
                    w0: float, device: torch.device | str = "cuda"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the latency probe: one block of ``lanes`` threads (1..32),
    each running ``n`` links of the chain named by ``chain`` (one of
    :data:`PROBE_CHAINS`) on a pilot sample of 1 and the gains, all in
    registers. Returns ``(result, cycles)`` on the card, one value per
    lane: the final phase (kept so that the compiler keeps the chain) and
    the SM cycles the loop took (``clock64``); the chain ``sample`` runs
    ``n // TILE`` tiles of :data:`TILE` links. Does not synchronise and
    counts no launch. A measuring aid for the card: there is no plain
    version."""
    from radiocore_tpu_torch.kernels import build
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nco_chain_probe: the probe times the card; got "
                         f"{device}")
    if chain not in PROBE_CHAINS:
        raise ValueError(f"nco_chain_probe: chain {chain!r} not in "
                         f"{PROBE_CHAINS}")
    if not (n >= 1 and 1 <= lanes <= 32):
        raise ValueError(f"nco_chain_probe: n={n}, lanes={lanes}")
    result = torch.empty(lanes, dtype=torch.float32, device=device)
    cycles = torch.empty(lanes, dtype=torch.int64, device=device)
    lib = build.library()
    err = lib.rc_nco_chain_probe(
        result.data_ptr(), cycles.data_ptr(), int(n),
        PROBE_CHAINS.index(chain), int(lanes), 1.0, float(kp),
        float(ki), float(w0), torch.cuda.current_stream(device).cuda_stream)
    build.check(err, f"rc_nco_chain_probe(n={n}, chain={chain}, "
                     f"lanes={lanes})")
    return result, cycles

"""K-NCO: the feedback NCO phase-locked loop as one kernel launch.

Counterpart of the ``lax.scan`` in ``radiocore_tpu/ops/nco_pll.py``
(``nco_pll_track``): per row (station) a sequential loop over the
samples that carries ``(phase, freq)``,

    err = x[t]·cos(phase);  traj[t] = phase;  freq += ki·err
    phase = ((phase + w0) + freq) + kp·err;  phase −= 2π where phase > π

:func:`nco_pll_track_plain` is that loop in PyTorch, in the scan's order
and float32, with the rows as the vector, one Python iteration per
sample: what :func:`nco_pll_track_rows` runs on a CPU tensor.

The kernel (``csrc/nco_pll.cu``, ``nco_pll_kernel_phasor``) gives a row
to a lane of a block's chain warp, whose helper warps stage the pilot and
write the output (:func:`nco_geometry`; a chain lane that finds its next
tile not yet staged counts it on :data:`starved`), and carries the NCO as
the phasor ``w = √2·e^{jφ}``. It reads the pilot with a per-row scale
(1/RMS), and per sample, with ``u = w·e^{jw0}`` and ``h = ψ/2``::

    ψ = f + (kp + ki)·s·x·Re w/√2;  f' = f + ki·s·x·Re w/√2
    w' = (ur − ψ·(ui + h·ur), ui + ψ·(ur − h·ui))

which is ``u·(1 − ψ²/2 + jψ)``, ``u·e^{jψ}`` within 2^-26 for ``|ψ| ≤``
:data:`PSI_MAX`. A tile of :data:`PHASOR_TILE` samples in which some
``|ψ|`` passed that is done again with the exact rotation and counted on
:data:`redone`; ``|w|²`` goes back to 2 once a tile. The state crosses
chunks as the phase (``atan2`` at the end, ``sin``/``cos`` at the
start). Each sample writes one of :data:`OUTPUTS`: the 38 kHz subcarrier
``−sin 2φ = −Re w·Im w`` (:func:`nco_pll_subcarrier_rows`, what the
stereo decoder runs), or the phase the detector saw, ``atan2(Im w, Re
w)`` (:func:`nco_pll_track_rows` on a CUDA tensor, with a scale of 1; its
first sample is the phase it was given, as in the scan). It rounds
otherwise than the scan, which carries the phase in float32: while the
loop acquires, the float32 scan drifts up to about 1e-4 rad from a
float64 loop, the kernel a few 1e-6. :func:`nco_pll_phasor_plain` is the
kernel's arithmetic in float32 on the CPU.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain loop. :func:`nco_chain_probe` times the bare chain on the card, the
kernel's least time a sample; no path calls it.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.kernels.fft_rows import LaunchCounter

# What a sample of the kernel writes; the index is the C entry's output
# code (csrc/nco_pll.cu kNcoSubcarrier, kNcoPhase).
OUTPUTS = ("subcarrier", "phase")

# The chains rc_nco_chain_probe times (csrc/nco_pll.cu
# nco_chain_probe_kernel): the bare recurrence (four dependent FP32
# operations a sample); the whole sample without its loads and stores;
# the chain lane's tiles, (a, b) from shared memory and w stored back.
PROBE_CHAINS = ("phasor", "phasor_sample", "chain_lane")

# The series limit (csrc/nco_pll.cu kNcoPsiMax): the series (1 - psi^2/2,
# psi) is e^{j psi} within 2^-26 up to here.
PSI_MAX = 2.0 ** -8

# Samples of a tile (csrc/nco_pll.cu kNcoPhasorTile): the series' guard
# and |w|'s renormalisation act once a tile.
PHASOR_TILE = 80

# A block of the kernel (csrc/nco_pll.cu): one chain warp whose lanes each
# own a row, at most CHAIN_LANES, and HELPERS helper warps.
CHAIN_LANES = 32
HELPERS = 3

launches = LaunchCounter()


def nco_geometry(rows: int, sms: int) -> Tuple[int, int]:
    """The kernel's launch for ``rows`` rows on a card of ``sms`` SMs:
    ``(blocks, lanes)``, ``lanes`` rows a block (the chain warp's lanes, a
    power of two). One block an SM while the rows allow it: a warp issues
    once for all its lanes, so rows share a chain warp for free, and a
    block alone on its SM keeps its chain warp on a scheduler no other
    warp uses (the SM gives its four schedulers to warps by index). Past
    CHAIN_LANES rows an SM, blocks share SMs. Every block has HELPERS
    helper warps."""
    if rows < 1 or sms < 1:
        raise ValueError(f"nco_geometry: rows={rows}, sms={sms}")
    per_sm = -(-rows // sms)
    lanes = 1
    while lanes < CHAIN_LANES and lanes < per_sm:
        lanes *= 2
    return -(-rows // lanes), lanes


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    count = _SMS.get(index)
    if count is None:
        count = torch.cuda.get_device_properties(index).multi_processor_count
        _SMS[index] = count
    return count


_SMS: Dict[int, int] = {}


class TileCounter:
    """A count of K-NCO's tiles, one a device: a persistent int64 on that
    device, added to by the kernel (so it counts under graph replay too)
    or by the plain loop. ``name`` is the module's name for it."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._counts: Dict[torch.device, torch.Tensor] = {}

    def tensor(self, device: torch.device | str) -> torch.Tensor:
        """The count on ``device``, made there at first use, which must
        not be inside a CUDA graph capture (a step warms up first)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        t = self._counts.get(device)
        if t is None:
            if (device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"nco_pll.{self.name}: first use on a device inside a "
                    f"graph capture; run the phasor once outside it first")
            t = torch.zeros(1, dtype=torch.int64, device=device)
            self._counts[device] = t
        return t

    def read(self, device: torch.device | str = "cpu") -> int:
        """The count on ``device`` so far, after the work queued there."""
        t = self.tensor(device)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return int(t.item())


# Tiles done again with the exact rotation.
redone = TileCounter("redone")
# Tiles a chain lane found not yet staged by its helpers, past each row's
# first: above 0, the helpers set the kernel's pace, not the chain. The
# plain loop has no helpers and leaves it as it is.
starved = TileCounter("starved")

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


def nco_pll_track_rows(pilot: torch.Tensor, kp: float, ki: float, w0: float,
                       phase: torch.Tensor, freq: torch.Tensor) -> Result:
    """The loop along the last axis of ``pilot`` with any leading batch
    dims: the kernel's phase output (a scale of 1 a row) on CUDA,
    :func:`nco_pll_track_plain` on the CPU. Returns the trajectory and
    the new phase and frequency."""
    kp, ki, w0 = float(kp), float(ki), float(w0)
    if pilot.is_cuda:
        ones = torch.ones(pilot.shape[:-1], dtype=torch.float32,
                          device=pilot.device)
        return _phasor_kernel(pilot, ones, kp, ki, w0, phase, freq, "phase")
    if pilot.device.type != "cpu":
        raise ValueError(f"nco_pll_track_rows: no kernel for {pilot.device}")
    return nco_pll_track_plain(pilot, kp, ki, w0, phase, freq)


def phasor_constants(kp: float, ki: float, w0: float
                     ) -> Tuple[float, float, float, float]:
    """The kernel's constants as float32 values: the gains over √2 (the
    phasor's length), ``(ki + kp)/√2`` (``ki + kp`` summed in float32)
    and ``ki/√2``, and ``(cw, sw) = e^{j w0}``, each computed in float64
    and rounded once."""
    f32 = np.float32
    kk = float(f32(ki) + f32(kp))
    return (float(f32(kk / math.sqrt(2.0))),
            float(f32(float(f32(ki)) / math.sqrt(2.0))),
            float(f32(math.cos(w0))), float(f32(math.sin(w0))))


def _phasor_span(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
                 f: torch.Tensor, rot: torch.Tensor, hist: torch.Tensor,
                 psis: torch.Tensor, mode: str) -> None:
    """Samples ``a.shape[0]`` of the phasor loop in place on ``w``
    ``(2, rows)`` (Re, Im) and ``f``: each sample's ``w`` before its
    rotation into ``hist`` ``(n, 2, rows)``, its ``psi`` into ``psis``
    ``(n, rows)``. ``mode``: ``"series"``, ``"exact"``, or ``"either"``
    (the series below :data:`PSI_MAX`, cos and sin above it)."""
    wr, wi = w.unbind(0)
    c = torch.empty_like(f)
    s = torch.empty_like(f)
    qr = torch.empty_like(f)
    qi = torch.empty_like(f)
    u = torch.empty_like(w)
    ur, ui = u.unbind(0)
    for at, bt, ht, psi in zip(a.unbind(0), b.unbind(0), hist.unbind(0),
                               psis.unbind(0)):
        ht.copy_(w)
        torch.addcmul(f, at, wr, out=psi)
        f.addcmul_(bt, wr)
        torch.mm(rot, w, out=u)                  # w e^{j w0}
        far = None
        if mode != "series":
            torch.cos(psi, out=c)
            torch.sin(psi, out=s)
            if mode == "either":
                far = psi.abs() > PSI_MAX
            else:
                torch.mul(u, c, out=w)
                wr.addcmul_(ui, s, value=-1.0)
                wi.addcmul_(ur, s)
                continue
        # u (1 - psi^2/2 + j psi) = (ur - psi qr, ui + psi qi)
        torch.addcmul(ui, psi, ur, value=0.5, out=qr)
        torch.addcmul(ur, psi, ui, value=-0.5, out=qi)
        if far is None:
            torch.addcmul(ur, psi, qr, value=-1.0, out=wr)
            torch.addcmul(ui, psi, qi, out=wi)
        else:
            w.copy_(torch.where(
                far, torch.stack([ur * c - ui * s, ui * c + ur * s]),
                torch.stack([torch.addcmul(ur, psi, qr, value=-1.0),
                             torch.addcmul(ui, psi, qi)])))


def nco_pll_phasor_plain(pilot: torch.Tensor, scale: torch.Tensor,
                         kp: float, ki: float, w0: float,
                         phase: torch.Tensor, freq: torch.Tensor,
                         output: str) -> Result:
    """Plain version of the kernel: a Python loop over the last axis of
    ``pilot`` ``(..., n)`` (``scale`` ``(...)`` its 1/RMS a row), the
    leading axes as the vector, in float32. Returns ``output`` (one of
    :data:`OUTPUTS`) ``(..., n)`` and the new ``phase`` (in (−π, π]) and
    ``freq`` ``(...)``. It walks the kernel's tiles: a tile on the
    series, done again with the exact rotation for the rows whose
    ``|psi|`` passed :data:`PSI_MAX` in it (counted on :data:`redone`),
    then ``|w|²`` back to 2; the ragged end sample by sample. The phase
    is ``torch.atan2`` (the kernel's branch-free arctangent is within
    2e-6 rad of it)."""
    if output not in OUTPUTS:
        raise ValueError(f"nco_pll_phasor_plain: output {output!r} not in "
                         f"{OUTPUTS}")
    f32 = torch.float32
    lead = tuple(pilot.shape[:-1])
    n = int(pilot.shape[-1])
    ak, ai, cw, sw = phasor_constants(kp, ki, w0)
    xs = pilot.to(f32).reshape(-1, n).t().contiguous()        # (n, rows)
    s_row = scale.to(f32).reshape(-1)
    a_all = xs * (s_row * torch.tensor(ak, dtype=f32))
    b_all = xs * (s_row * torch.tensor(ai, dtype=f32))
    ph = phase.to(f32).reshape(-1)
    w = torch.stack([torch.cos(ph), torch.sin(ph)]) * torch.tensor(
        math.sqrt(2.0), dtype=f32)
    f = freq.to(f32).reshape(-1).clone()
    rot = torch.tensor([[cw, -sw], [sw, cw]], dtype=f32)
    hist = torch.empty((n, 2, xs.shape[1]), dtype=f32)
    psis = torch.empty((PHASOR_TILE, xs.shape[1]), dtype=f32)
    count = 0
    end = n - n % PHASOR_TILE
    for t0 in range(0, end, PHASOR_TILE):
        t1 = t0 + PHASOR_TILE
        w0_, f0 = w.clone(), f.clone()
        _phasor_span(a_all[t0:t1], b_all[t0:t1], w, f, rot, hist[t0:t1],
                     psis, "series")
        far = psis.abs().amax(0) > PSI_MAX
        if bool(far.any()):
            h_x = torch.empty_like(hist[t0:t1])
            _phasor_span(a_all[t0:t1], b_all[t0:t1], w0_, f0, rot, h_x,
                         psis, "exact")
            w = torch.where(far, w0_, w)
            f = torch.where(far, f0, f)
            hist[t0:t1] = torch.where(far, h_x, hist[t0:t1])
            count += int(far.sum())
        w.mul_(torch.addcmul(torch.full_like(f, 1.5), (w * w).sum(0),
                             torch.full_like(f, -0.25)))
    _phasor_span(a_all[end:], b_all[end:], w, f, rot, hist[end:], psis,
                 "either")
    redone.tensor("cpu").add_(count)
    if output == "subcarrier":
        out = (-hist[:, 0]).mul_(hist[:, 1])
    else:
        out = torch.atan2(hist[:, 1], hist[:, 0])
        out[0] = ph          # the phase given, as the scan's first sample
    return (out.t().reshape(lead + (n,)),
            torch.atan2(w[1], w[0]).reshape(lead), f.reshape(lead))


def nco_pll_subcarrier_plain(pilot: torch.Tensor, scale: torch.Tensor,
                             kp: float, ki: float, w0: float,
                             phase: torch.Tensor, freq: torch.Tensor
                             ) -> Result:
    """:func:`nco_pll_phasor_plain` with the subcarrier ``−sin 2φ`` as
    its output: the plain version of :func:`nco_pll_subcarrier_rows`."""
    return nco_pll_phasor_plain(pilot, scale, kp, ki, w0, phase, freq,
                                "subcarrier")


def _phasor_kernel(pilot: torch.Tensor, scale: torch.Tensor, kp: float,
                   ki: float, w0: float, phase: torch.Tensor,
                   freq: torch.Tensor, output: str) -> Result:
    from radiocore_tpu_torch.kernels import build
    what = f"K-NCO ({output})"
    if pilot.dtype != torch.float32:
        raise TypeError(f"{what}: kernel takes float32, got {pilot.dtype}")
    lead = tuple(pilot.shape[:-1])
    n = int(pilot.shape[-1])
    for name, s in (("scale", scale), ("phase", phase), ("freq", freq)):
        if (not s.is_cuda or s.dtype != torch.float32
                or tuple(s.shape) != lead):
            raise ValueError(
                f"{what}: {name} must be float32 CUDA of shape {lead}, got "
                f"{s.dtype} {tuple(s.shape)} on {s.device}")
    if n < 1 or pilot.numel() == 0:
        raise ValueError(f"{what}: empty pilot {tuple(pilot.shape)}")
    x2 = pilot.reshape(-1, n)
    if x2.stride(-1) != 1 and n > 1:
        raise ValueError(f"{what}: pilot needs unit stride along its last "
                         f"axis")
    rows = x2.shape[0]
    s_in = scale.reshape(-1).contiguous()
    p_in = phase.reshape(-1).contiguous()
    f_in = freq.reshape(-1).contiguous()
    out = torch.empty((rows, n), dtype=torch.float32, device=pilot.device)
    p_out = torch.empty_like(p_in)
    f_out = torch.empty_like(f_in)
    _, lanes = nco_geometry(rows, _sm_count(pilot.device))
    lib = build.library()
    err = lib.rc_nco_pll(
        x2.data_ptr(), x2.stride(0), s_in.data_ptr(), p_in.data_ptr(),
        f_in.data_ptr(), out.data_ptr(), p_out.data_ptr(), f_out.data_ptr(),
        redone.tensor(pilot.device).data_ptr(),
        starved.tensor(pilot.device).data_ptr(), rows, n, lanes,
        *phasor_constants(kp, ki, w0), OUTPUTS.index(output),
        torch.cuda.current_stream().cuda_stream)
    build.check(err, f"rc_nco_pll(rows={rows}, n={n}, lanes={lanes}, "
                     f"output={output})")
    launches.count += 1
    return out.reshape(pilot.shape), p_out.reshape(lead), f_out.reshape(lead)


def nco_pll_subcarrier_rows(pilot: torch.Tensor, scale: torch.Tensor,
                            kp: float, ki: float, w0: float,
                            phase: torch.Tensor, freq: torch.Tensor
                            ) -> Result:
    """The loop along the last axis of ``pilot`` with any leading batch
    dims, each row scaled by ``scale``: the kernel's subcarrier output on
    CUDA, :func:`nco_pll_subcarrier_plain` on the CPU. Returns the
    subcarrier and the new phase and frequency."""
    kp, ki, w0 = float(kp), float(ki), float(w0)
    if pilot.is_cuda:
        return _phasor_kernel(pilot, scale, kp, ki, w0, phase, freq,
                              "subcarrier")
    if pilot.device.type != "cpu":
        raise ValueError(f"nco_pll_subcarrier_rows: no kernel for "
                         f"{pilot.device}")
    return nco_pll_subcarrier_plain(pilot, scale, kp, ki, w0, phase, freq)


def nco_chain_probe(n: int, chain: str, lanes: int, kp: float, ki: float,
                    w0: float, device: torch.device | str = "cuda",
                    helpers: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the latency probe: one block of ``lanes`` threads (1..32),
    each running ``n`` links of the chain named by ``chain`` (one of
    :data:`PROBE_CHAINS`) on a pilot sample of 1 and the gains, with
    ``helpers`` (0..3) warps beside them kept busy with multiply-adds and
    shared stores. Returns ``(result, cycles)`` on the card, one value per
    lane: the final phase (kept so that the compiler keeps the chain) and
    the SM cycles the loop took (``clock64``). Does not synchronise and
    counts no launch; the chains ``phasor_sample`` and ``chain_lane`` run
    ``n // PHASOR_TILE`` tiles. A measuring aid for the card: there is no
    plain version."""
    from radiocore_tpu_torch.kernels import build
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nco_chain_probe: the probe times the card; got "
                         f"{device}")
    if chain not in PROBE_CHAINS:
        raise ValueError(f"nco_chain_probe: chain {chain!r} not in "
                         f"{PROBE_CHAINS}")
    if not (n >= 1 and 1 <= lanes <= 32 and 0 <= helpers <= HELPERS):
        raise ValueError(f"nco_chain_probe: n={n}, lanes={lanes}, "
                         f"helpers={helpers}")
    result = torch.empty(lanes, dtype=torch.float32, device=device)
    cycles = torch.empty(lanes, dtype=torch.int64, device=device)
    lib = build.library()
    err = lib.rc_nco_chain_probe(
        result.data_ptr(), cycles.data_ptr(), int(n),
        PROBE_CHAINS.index(chain), int(lanes), int(helpers), 1.0, float(kp),
        float(ki), float(w0), torch.cuda.current_stream(device).cuda_stream)
    build.check(err, f"rc_nco_chain_probe(n={n}, chain={chain}, "
                     f"lanes={lanes})")
    return result, cycles

"""Fused multi-station pipeline on one device; counterpart of
``radiocore_tpu/parallel/pipeline.py`` (``make_multi_station_step`` on a
single device: ``mode='exact'``, and ``mode='fast'`` with the hoisted
station rfft and the fused extract+demod paths of
``RADIOCORE_TPU_EXTRACT_DEMOD``).

    band IQ (n_band,) ──K-FFT or K-MIXED──► spectrum
    exact:   ──K-EXTRACT──► (C, m) station IQ ──exact WBFM step over the
             station batch (K-FIR pilot bandpass and de-emphasis)──► audio
    fast:
      off:   ──K-EXTRACT──► (C, m) station IQ ──demod──► quad
      fused: ──K-XDEMOD──► quad
             quad ──K-FFT rfft──► composite spectra
      spec:  ──K-XDEMOD-SPEC──► composite spectra (needed bins only)
    composite spectra ──fast_spec tail (K-FIR de-emphasis)──► audio
        (C, audio_chunk, 2)

On a CUDA device every kernel stage runs the hand-written kernel; on
the CPU the same code runs their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.kernels.extract_demod import (
    extract_demod_ok, extract_demod_rows, extract_demod_spec_ok,
    extract_demod_spec_rows)
from radiocore_tpu_torch.models.wbfm import make_wbfm_step, wbfm_init_state
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.channelize import (make_extractor,
                                                uniform_extraction_start)
from radiocore_tpu_torch.ops.demod import quadrature_demod
from radiocore_tpu_torch.runtime.platform import resolve_device

State = Dict[str, torch.Tensor]


def make_multi_station_step(
        n_band: int,
        offsets_hz: Sequence[int],
        station_chunk: int,
        audio_chunk: int,
        deemphasis: float = 75e-6,
        mode: str = "exact",
        extract_demod: str = "off",
        *,
        device: Optional[torch.device | str] = None,
) -> Tuple[Callable[[torch.Tensor, State], Tuple[torch.Tensor, State]],
           State]:
    """Build ``step(band_iq, state) -> (audio, state)`` plus the initial
    state on ``device`` (the first CUDA device when None, as the model
    classes resolve it).

    ``n_band`` is the band chunk (== band sample rate, one-second
    convention), ``offsets_hz`` the station offsets from the band centre
    (== bins), ``station_chunk`` the per-station IQ chunk and
    ``audio_chunk`` the audio samples per station per chunk.

    ``mode`` is the WBFM step's: ``"exact"`` runs the reference pipeline
    over the extracted station batch, ``"fast"`` the envelope-domain one.

    ``extract_demod`` is the JAX package's ``RADIOCORE_TPU_EXTRACT_DEMOD``
    as an argument, for ``mode="fast"`` (the reference takes the fused
    routes in no other mode; here anything but ``"off"`` with
    ``mode="exact"`` raises): ``"off"`` extracts the station IQ and
    demodulates it;
    ``"fused"`` turns the band spectrum into the quad in one kernel
    (K-XDEMOD) and takes its rfft; ``"spec"`` turns it into the composite
    spectra the tail reads (K-XDEMOD-SPEC). A plan the fused kernels do
    not support raises ``ValueError`` (the JAX package falls back to
    ``"off"`` there).

    ``step.stages`` holds the three stages that ``step`` chains, for
    per-stage timing: ``band_fft``, ``extract`` and ``demod_tail`` for
    ``"off"``; ``band_fft``, ``extract_demod`` and ``tail`` otherwise.
    """
    if mode not in ("exact", "fast"):
        raise ValueError(f"unknown mode {mode!r}; 'exact' or 'fast'")
    if extract_demod not in ("off", "fused", "spec"):
        raise ValueError(f"extract_demod={extract_demod!r}: expected "
                         f"'off', 'fused' or 'spec'")
    if mode == "exact" and extract_demod != "off":
        raise ValueError(f"extract_demod={extract_demod!r} needs "
                         f"mode='fast': the exact step works on the "
                         f"station IQ")
    device = resolve_device(device)
    n_stations = len(offsets_hz)
    n_band = int(n_band)
    sc = int(station_chunk)
    # Roll = band_center − station_center = −offset (tuner convention).
    shifts = tuple(int(-o) for o in offsets_hz)
    spec = extract_demod == "spec"
    if extract_demod != "off":
        a0 = uniform_extraction_start(n_band, shifts, sc)
        ok = extract_demod_spec_ok if spec else extract_demod_ok
        if a0 is None or sc % 2 or not ok(n_band, sc, n_stations):
            raise ValueError(
                f"extract_demod={extract_demod!r}: unsupported plan "
                f"n_band={n_band}, station_chunk={sc}, "
                f"{n_stations} stations (needs a uniform plan that "
                f"{ok.__name__} accepts)")
    tail = make_wbfm_step(
        sc, audio_chunk, deemphasis,
        mode="exact" if mode == "exact" else "fast_spec")
    h = sc // 2
    kernel_rfft = ((sc & (sc - 1)) == 0
                   and fft_rows.MIN_ROW <= h <= fft_rows.MAX_ROW)

    def band_fft(band_iq: torch.Tensor) -> torch.Tensor:
        return _fft.fft(band_iq)

    def station_rfft(quad: torch.Tensor) -> torch.Tensor:
        return fft_rows.rfft_pow2(quad) if kernel_rfft else _fft.rfft(quad)

    if extract_demod == "off":
        extract = make_extractor(n_band, shifts, sc)

        def extract_stations(spectrum: torch.Tensor) -> torch.Tensor:
            return extract(spectrum).to(torch.complex64)

        if mode == "exact":
            demod_tail = tail   # batch-generic: the stations ride along
        else:
            def demod_tail(st_iq: torch.Tensor, state: State
                           ) -> Tuple[torch.Tensor, State]:
                return tail(station_rfft(quadrature_demod(st_iq)), state)

        stages = {"band_fft": band_fft, "extract": extract_stations,
                  "demod_tail": demod_tail}
    else:
        nb = int(tail.needed_bins)

        if spec:
            def xdemod(spectrum: torch.Tensor) -> torch.Tensor:
                return extract_demod_spec_rows(spectrum, a0, n_stations, sc,
                                               keep_bins=nb)

            def xtail(q_spec: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, State]:
                return tail(q_spec[:, :nb], state)
        else:
            def xdemod(spectrum: torch.Tensor) -> torch.Tensor:
                return extract_demod_rows(spectrum, a0, n_stations, sc)

            def xtail(quad: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, State]:
                return tail(station_rfft(quad), state)

        stages = {"band_fft": band_fft, "extract_demod": xdemod,
                  "tail": xtail}

    first, middle, last = stages.values()

    def step(band_iq: torch.Tensor, state: State
             ) -> Tuple[torch.Tensor, State]:
        return last(middle(first(band_iq)), state)

    step.stages = stages
    state0 = wbfm_init_state(audio_chunk, deemphasis,
                             batch_shape=(n_stations,), device=device)
    return step, state0

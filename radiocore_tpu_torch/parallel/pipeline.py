"""Fused multi-station pipeline on one device; counterpart of
``radiocore_tpu/parallel/pipeline.py`` (``make_multi_station_step``,
``mode='fast'``, single device, hoisted station rfft).

    band IQ (n_band,) ──K-FFT──► spectrum ──K-EXTRACT──► (C, m) station IQ
        ──demod──► quad ──K-FFT rfft──► composite spectra
        ──fast_spec tail (K-FIR de-emphasis)──► audio (C, audio_chunk, 2)

On a CUDA device every kernel stage runs the hand-written kernel; on
the CPU the same code runs their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.models.wbfm import make_wbfm_step, wbfm_init_state
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.channelize import make_extractor
from radiocore_tpu_torch.ops.demod import quadrature_demod

State = Dict[str, torch.Tensor]


def make_multi_station_step(
        n_band: int,
        offsets_hz: Sequence[int],
        station_chunk: int,
        audio_chunk: int,
        deemphasis: float = 75e-6,
        mode: str = "fast",
        *,
        device: torch.device | str,
) -> Tuple[Callable[[torch.Tensor, State], Tuple[torch.Tensor, State]],
           State]:
    """Build ``step(band_iq, state) -> (audio, state)`` plus the initial
    state on ``device``.

    ``n_band`` is the band chunk (== band sample rate, one-second
    convention), ``offsets_hz`` the station offsets from the band centre
    (== bins), ``station_chunk`` the per-station IQ chunk and
    ``audio_chunk`` the audio samples per station per chunk.

    ``step.stages`` holds the three stages (band FFT, extraction, demod
    + tail) that ``step`` chains, for per-stage timing.
    """
    if mode != "fast":
        raise NotImplementedError(f"mode={mode!r}: only 'fast' is ported")
    n_stations = len(offsets_hz)
    sc = int(station_chunk)
    # Roll = band_center − station_center = −offset (tuner convention).
    extract = make_extractor(int(n_band), tuple(int(-o) for o in offsets_hz),
                             sc)
    tail = make_wbfm_step(sc, audio_chunk, deemphasis, mode="fast_spec")
    h = sc // 2
    kernel_rfft = ((sc & (sc - 1)) == 0
                   and fft_rows.MIN_ROW <= h <= fft_rows.MAX_ROW)

    def band_fft(band_iq: torch.Tensor) -> torch.Tensor:
        return _fft.fft(band_iq)

    def extract_stations(spectrum: torch.Tensor) -> torch.Tensor:
        return extract(spectrum).to(torch.complex64)

    def demod_tail(st_iq: torch.Tensor, state: State
                   ) -> Tuple[torch.Tensor, State]:
        quad = quadrature_demod(st_iq)
        q_spec = (fft_rows.rfft_pow2(quad) if kernel_rfft
                  else _fft.rfft(quad))
        return tail(q_spec, state)

    def step(band_iq: torch.Tensor, state: State
             ) -> Tuple[torch.Tensor, State]:
        return demod_tail(extract_stations(band_fft(band_iq)), state)

    step.stages = {"band_fft": band_fft, "extract": extract_stations,
                   "demod_tail": demod_tail}
    state0 = wbfm_init_state(audio_chunk, deemphasis,
                             batch_shape=(n_stations,), device=device)
    return step, state0

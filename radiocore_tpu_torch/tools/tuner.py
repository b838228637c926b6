"""Channelizer: one full-band FFT → per-station spectrum extraction;
counterpart of ``radiocore_tpu/tools/tuner.py``.

API parity with reference ``radiocore/tools/tuner.py:38-174``
(``add_channel`` / ``request_bandwidth`` / ``channels`` / ``load`` /
``run`` / ``reset`` and the band recalculation rules, including padding
the band to a multiple of the mean channel bandwidth,
reference: tuner.py:163-174). Assumes the one-second-chunk convention:
Hz == array index == FFT bin (reference: tuner.py:43-44).

``load`` takes the band FFT through ``ops/fft.fft`` (K-FFT for a 2^24
band on the card, K-MIXED for a·2^k ≥ 2^23, ``torch.fft`` otherwise).
``run_all`` extracts every channel at once through
``ops/channelize.make_extractor`` (K-EXTRACT for a uniform power-of-two
plan on the card); per-channel ``run(i)`` (roll, fftshift'd hann window,
frequency-domain resample) remains for drop-in parity and for
heterogeneous channel bandwidths.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from radiocore_tpu_torch.ops import design
from radiocore_tpu_torch.ops import fft as _fft
from radiocore_tpu_torch.ops.channelize import make_extractor
from radiocore_tpu_torch.ops.resample import resample_spectrum
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.transfer import to_device_c64


@dataclasses.dataclass
class Channel:
    """Frequency boundaries and demodulator binding of one station.

    ``address_bytes`` is the 4-byte little-endian center frequency used as
    the ZMQ PUB topic (reference: tuner.py:33-35).
    """

    index: int
    bandwidth: float
    demodulator: object
    lower_frequency: float
    center_frequency: float
    higher_frequency: float

    @property
    def address_bytes(self) -> bytes:
        return int(self.center_frequency).to_bytes(4, byteorder="little")


class Tuner:
    """Runs on ``device`` (the first CUDA device when None); ``cuda`` is
    kept for the reference's signature."""

    def __init__(self, cuda: bool = False, *,
                 device: Optional[torch.device | str] = None):
        del cuda
        self._device = resolve_device(device)
        self._channels: List[Channel] = []
        self._input_frequency: float = 0.0
        self._input_bandwidth: float = 0.0
        self._spectrum: Optional[torch.Tensor] = None
        self._win_cache: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    # ---- band plan -------------------------------------------------------

    @property
    def device(self) -> torch.device:
        """The device the band and the channels live on."""
        return self._device

    @property
    def input_frequency(self) -> float:
        """Center frequency the SDR should be tuned to."""
        return self._input_frequency

    @property
    def input_bandwidth(self) -> float:
        """Sample rate the SDR should run at (== band width, Hz)."""
        return self._input_bandwidth

    def channels(self) -> List[Channel]:
        """The configured Channel list (reference parity)."""
        return self._channels

    def request_bandwidth(self, bandwidth: float) -> None:
        """Override the computed bandwidth upward only (reference: tuner.py:77-94)."""
        if bandwidth < self._input_bandwidth:
            raise ValueError(
                f"requested bandwidth ({bandwidth}) is too low, "
                f"minimum is {self._input_bandwidth}")
        self._input_bandwidth = bandwidth

    def add_channel(self, frequency: float, bandwidth: float,
                    demodulator) -> None:
        """Register a station (frequency, bandwidth); recomputes the band
        plan exactly like the reference (mean-bandwidth padding)."""
        self._channels.append(Channel(
            index=len(self._channels),
            bandwidth=bandwidth,
            demodulator=demodulator,
            lower_frequency=frequency - bandwidth / 2,
            center_frequency=frequency,
            higher_frequency=frequency + bandwidth / 2,
        ))
        self._recalculate()

    def reset(self) -> None:
        """Clear all channels and the loaded band."""
        self._channels = []
        self._spectrum = None
        self._input_frequency = 0.0
        self._input_bandwidth = 0.0

    def _recalculate(self) -> None:
        """Band center/width from channel extremes, padded so the width is
        divisible by the (integer-floored) mean channel bandwidth
        (reference: tuner.py:163-174)."""
        lo = min(ch.lower_frequency for ch in self._channels)
        hi = max(ch.higher_frequency for ch in self._channels)
        self._input_frequency = (lo + hi) / 2
        self._input_bandwidth = hi - lo
        mean_bw = sum(ch.bandwidth for ch in self._channels) // len(self._channels)
        self._input_bandwidth += (-self._input_bandwidth) % mean_bw

    # ---- processing ------------------------------------------------------

    def _shift(self, channel: Channel) -> int:
        """Spectrum roll (bins == Hz under the one-second convention)."""
        return int(self._input_frequency - channel.center_frequency)

    def load(self, input_signal) -> None:
        """FFT the full-band 1-second chunk (reference: tuner.py:126-138).
        A tensor already on the device as complex64 is not copied."""
        self._spectrum = _fft.fft(to_device_c64(input_signal, self._device))

    def _window(self, n: int) -> torch.Tensor:
        key = (n, self._device)
        if key not in self._win_cache:
            self._win_cache[key] = torch.from_numpy(
                np.fft.fftshift(design.window("hann", n)).astype(
                    np.float32)).to(self._device)
        return self._win_cache[key]

    def run(self, channel_index: int) -> torch.Tensor:
        """Extract one channel's baseband IQ (parity path).

        Roll the spectrum by the frequency offset and resample to
        ``int(bandwidth)`` samples in the frequency domain with an
        fftshift'd hann window (reference: tuner.py:140-161).
        """
        if self._spectrum is None:
            raise ValueError("load() must be called before run()")
        ch = self._channels[int(channel_index)]
        n = self._spectrum.shape[-1]
        rolled = torch.roll(self._spectrum, self._shift(ch))
        return resample_spectrum(rolled * self._window(n), int(ch.bandwidth))

    def run_all(self) -> torch.Tensor:
        """Extract ALL channels at once → ``(n_channels, bandwidth)`` c64.

        Requires homogeneous channel bandwidths (the common band-plan
        case); use ``run(i)`` otherwise.
        """
        if self._spectrum is None:
            raise ValueError("load() must be called before run_all()")
        bws = {int(ch.bandwidth) for ch in self._channels}
        if len(bws) != 1:
            raise ValueError("run_all requires equal channel bandwidths; "
                             "use run(i) for heterogeneous plans")
        n = int(self._spectrum.shape[-1])
        shifts = tuple(self._shift(ch) for ch in self._channels)
        extract = make_extractor(n, shifts, bws.pop())
        return extract(self._spectrum).to(torch.complex64)

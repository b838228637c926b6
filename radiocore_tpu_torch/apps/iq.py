"""IQ sources and audio sinks for the receiver apps; a copy of
``radiocore_tpu/apps/iq.py`` over the port's own native converter.
Host-only: every chunk is a NumPy array.

The reference's only source is live SoapySDR hardware
(reference: ``examples/receive_fm.py:24-64``), which makes its examples
unrunnable without an SDR. Here the source is an interface with three
implementations: synthetic multi-station FM (for tests/bench), CF32 IQ
file playback, and (optional, when installed) SoapySDR.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


class SyntheticFmSource:
    """Generates a full-band chunk stream of FM stereo multiplex stations.

    Each station is an FM-modulated stereo multiplex (tone pair) placed at
    an offset within the band — the synthetic stand-in for an SDR tuned to
    a crowded FM dial.
    """

    def __init__(self, band_rate: int, offsets_hz: Sequence[int],
                 station_rate: int,
                 tones: Optional[Sequence[Tuple[float, float]]] = None,
                 deviation_gain: float = 0.25, seed: int = 0):
        self.band_rate = int(band_rate)
        self.station_rate = int(station_rate)
        self.offsets_hz = [int(o) for o in offsets_hz]
        if tones is None:
            tones = [(300.0 + 50 * i, 700.0 + 80 * i)
                     for i in range(len(self.offsets_hz))]
        self.tones = list(tones)
        self._gain = deviation_gain
        self._rng = np.random.default_rng(seed)
        self._chunk_idx = 0

    def _station_iq(self, n: int, f_l: float, f_r: float,
                    t0: float) -> np.ndarray:
        fs = self.station_rate
        t = t0 + np.arange(n) / fs
        left = 0.3 * np.sin(2 * np.pi * f_l * t)
        right = 0.3 * np.sin(2 * np.pi * f_r * t)
        pilot = 0.1 * np.sin(2 * np.pi * 19e3 * t)
        sub_gain = 1.0 / (0.54 + 0.46 * np.cos(2 * np.pi * 38e3 / fs))
        mpx = ((left + right) / 2 + pilot
               - np.sin(2 * np.pi * 38e3 * t) * (left - right) * sub_gain)
        phase = np.pi * self._gain * np.cumsum(mpx)
        return np.exp(1j * phase)

    def read_chunk(self, seconds: float = 1.0) -> np.ndarray:
        """Return the next ``seconds`` of full-band complex64 IQ."""
        n_band = int(self.band_rate * seconds)
        n_st = int(self.station_rate * seconds)
        t0 = self._chunk_idx * seconds
        self._chunk_idx += 1
        ratio = n_band / n_st
        h = n_st // 2
        # Upconversion by an integer-bin offset (offsets are stored as
        # ints: Hz == bin under the one-second convention) is a spectrum
        # ROLL, so the whole band needs ONE inverse FFT instead of one
        # per station (matters at the 100+-station config-5 scale).
        band_spec = np.zeros(n_band, np.complex128)
        for off, (fl, fr) in zip(self.offsets_hz, self.tones):
            spec = np.fft.fft(self._station_iq(n_st, fl, fr, t0))
            lo = np.arange(off - h, off) % n_band
            hi = np.arange(off, off + h) % n_band
            band_spec[hi] += spec[:h]
            band_spec[lo] += spec[-h:]
        band = np.fft.ifft(band_spec) * ratio
        band += 1e-4 * (self._rng.standard_normal(n_band)
                        + 1j * self._rng.standard_normal(n_band))
        return (band / max(len(self.offsets_hz), 1)).astype(np.complex64)


# Raw SDR wire formats: interleaved IQ scalars. cu8 = RTL-SDR offset
# binary, cs8 = HackRF, cs16 = USRP/SDRplay/Airspy, cf32 = interchange.
IQ_FORMATS = ("cf32", "cu8", "cs8", "cs16")
_WIRE_DTYPE = {"cu8": np.uint8, "cs8": np.int8, "cs16": np.int16}


def convert_iq(raw: np.ndarray, fmt: str) -> np.ndarray:
    """Interleaved fixed-point IQ scalars → complex64.

    Hot host path at stream rate (2 scalars per sample at up to
    61.44 MS/s); dispatches to the native C++ kernels
    (radiocore_tpu_torch/native/iqconvert.cpp) when built, NumPy otherwise.
    """
    if len(raw) % 2:
        raw = raw[:-1]  # drop trailing unpaired scalar (short SDR read)
    if fmt == "cf32":
        return np.ascontiguousarray(raw).view(np.complex64)
    if fmt not in _WIRE_DTYPE:
        raise ValueError(f"unknown IQ format {fmt!r}; one of {IQ_FORMATS}")
    from radiocore_tpu_torch.native.build import iq_convert_native
    f32 = iq_convert_native(raw, fmt)
    if f32 is None:  # no C++ toolchain: NumPy fallback, same math
        if fmt == "cu8":
            f32 = (raw.astype(np.float32) - 127.5) * (1.0 / 127.5)
        elif fmt == "cs8":
            f32 = raw.astype(np.float32) * (1.0 / 128.0)
        else:
            f32 = raw.astype(np.float32) * (1.0 / 32768.0)
    return f32.view(np.complex64)


class IQFileSource:
    """Streams complex64 IQ chunks from a raw IQ file (looping).

    ``fmt`` selects the wire format (see ``IQ_FORMATS``); fixed-point
    formats are converted through the native C++ data-loader path.
    """

    def __init__(self, path: str, sample_rate: int, fmt: str = "cf32"):
        if fmt not in IQ_FORMATS:
            raise ValueError(f"unknown IQ format {fmt!r}; one of {IQ_FORMATS}")
        self.path = path
        self.sample_rate = int(sample_rate)
        self.fmt = fmt
        # Memory-map the wire file and convert lazily per chunk: a
        # multi-minute 61.44 MS/s fixed-point capture converted eagerly
        # would transiently hold wire + cf32 arrays (~12 bytes/sample
        # for cs16) — tens of GB of host RAM.
        self._wire = np.memmap(path, dtype=_WIRE_DTYPE.get(fmt, np.complex64),
                               mode="r")
        self._scalars_per_sample = 1 if fmt == "cf32" else 2
        self._n_samples = len(self._wire) // self._scalars_per_sample
        if self._n_samples == 0:
            raise ValueError(f"empty IQ file: {path}")
        self._pos = 0

    def read_chunk(self, seconds: float = 1.0) -> np.ndarray:
        """Read ``seconds`` of IQ from the file (wraps at EOF)."""
        n = int(self.sample_rate * seconds)
        out = np.empty(n, np.complex64)
        sps = self._scalars_per_sample
        filled = 0
        while filled < n:
            take = min(n - filled, self._n_samples - self._pos)
            wire = np.ascontiguousarray(
                self._wire[self._pos * sps:(self._pos + take) * sps])
            if self.fmt == "cf32":
                out[filled:filled + take] = wire
            else:
                out[filled:filled + take] = convert_iq(wire, self.fmt)
            self._pos = (self._pos + take) % self._n_samples
            filled += take
        return out


def write_iq_file(path: str, iq: np.ndarray, fmt: str = "cf32") -> None:
    """Write complex64 IQ samples as raw CF32 or CS16 (recording path)."""
    iq = np.asarray(iq, dtype=np.complex64)
    if fmt == "cf32":
        iq.tofile(path)
        return
    if fmt != "cs16":
        raise ValueError(f"unsupported recording format {fmt!r}")
    scalars = iq.view(np.float32)
    from radiocore_tpu_torch.native.build import iq_f32_to_s16_native
    pcm = iq_f32_to_s16_native(scalars)
    if pcm is None:
        # Half-away-from-zero, matching the native kernel bit-for-bit
        # (np.round would round half-to-even).
        v = scalars * 32767.0
        pcm = np.clip(np.trunc(v + np.copysign(0.5, v)),
                      -32768, 32767).astype(np.int16)
    pcm.tofile(path)


class SoapySdrSource:
    """Live SDR source via SoapySDR (optional dependency).

    Mirrors the reference's reader thread setup — CF32 RX stream read in
    64 Ki-sample slabs (reference: ``examples/receive_fm.py:24-64``) —
    behind the same ``read_chunk`` interface as the synthetic/file
    sources. Import of SoapySDR happens lazily so headless environments
    never touch it.
    """

    def __init__(self, sample_rate: float, frequency: float,
                 device_args: str = "", agc: bool = True,
                 slab: int = 65536):
        import SoapySDR  # noqa: PLC0415 - optional hardware dependency
        from SoapySDR import SOAPY_SDR_RX, SOAPY_SDR_CF32

        self.sample_rate = int(sample_rate)
        self._slab = int(slab)
        self._sdr = SoapySDR.Device(device_args)
        self._sdr.setSampleRate(SOAPY_SDR_RX, 0, float(sample_rate))
        self._sdr.setFrequency(SOAPY_SDR_RX, 0, float(frequency))
        self._sdr.setGainMode(SOAPY_SDR_RX, 0, bool(agc))
        self._stream = self._sdr.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CF32)
        self._sdr.activateStream(self._stream)

    def read_chunk(self, seconds: float = 1.0) -> np.ndarray:
        """Read ``seconds`` of IQ from the SDR stream."""
        n = int(self.sample_rate * seconds)
        out = np.empty(n, np.complex64)
        staging = np.empty(self._slab, np.complex64)
        filled = 0
        while filled < n:
            status = self._sdr.readStream(self._stream, [staging],
                                          self._slab)
            got = status.ret
            if got <= 0:
                continue
            take = min(got, n - filled)
            out[filled:filled + take] = staging[:take]
            filled += take
        return out

    def close(self) -> None:
        """Stop and close the SDR stream."""
        self._sdr.deactivateStream(self._stream)
        self._sdr.closeStream(self._stream)


class AudioDeviceSink:
    """Live audio output via sounddevice (optional dependency).

    Equivalent of the reference's PortAudio callback with silence on
    underrun (reference: ``examples/receive_fm.py:122-132``).
    """

    def __init__(self, sample_rate: int, channels: int = 2):
        import queue
        import sounddevice as sd  # noqa: PLC0415 - optional dependency

        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self._queue = queue.Queue(maxsize=8)

        def callback(outdata, frames, time_info, status):  # noqa: ARG001
            try:
                outdata[:] = self._queue.get_nowait()
            except Exception:
                outdata[:] = 0.0  # underrun → silence

        self._stream = sd.OutputStream(
            samplerate=self.sample_rate, channels=self.channels,
            blocksize=self.sample_rate, callback=callback)
        self._stream.start()

    def write(self, audio: np.ndarray) -> None:
        """Append one chunk of float audio (any shape (N,) or (N, C))."""
        try:
            self._queue.put_nowait(np.asarray(audio, np.float32)
                                   .reshape(-1, self.channels))
        except Exception:
            pass  # drop on backpressure, like the reference's queue

    def close(self) -> None:
        """Stop the stream and release the device."""
        self._stream.stop()
        self._stream.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class WavSink:
    """Accumulates audio chunks and writes a 16-bit WAV on close."""

    def __init__(self, path: str, sample_rate: int):
        self.path = path
        self.sample_rate = int(sample_rate)
        self._chunks: List[np.ndarray] = []

    def write(self, audio: np.ndarray) -> None:
        """Append one chunk of float audio."""
        self._chunks.append(np.asarray(audio, dtype=np.float32))

    def close(self) -> None:
        """Write the accumulated audio as a 16-bit WAV."""
        from scipy.io import wavfile
        if not self._chunks:
            return
        audio = np.concatenate(self._chunks, axis=0)
        pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)
        wavfile.write(self.path, self.sample_rate, pcm)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

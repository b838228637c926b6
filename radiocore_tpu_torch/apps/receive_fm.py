"""Single-station FM receiver (reference: ``examples/receive_fm.py``);
counterpart of ``radiocore_tpu/apps/receive_fm.py``.

Same three-stage shape as the reference — source thread → RingBuffer →
DSP loop → audio sink — with the hardware edges made pluggable: source
is synthetic / IQ file / SoapySDR (when installed), sink is a WAV file /
sounddevice (when installed). DSP per 1-second chunk on the device:
``Decimate(input_rate → demod_rate)`` then ``WBFM(demod_rate →
audio_rate)`` or ``MFM`` (reference: receive_fm.py:76-103). Every CUDA
call stays on the consumer's thread; the producer thread touches host
memory only.

Run headless (``--device cpu`` without a card):
    python -m radiocore_tpu_torch.apps.receive_fm --seconds 3 --out fm.wav
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Optional

import numpy as np
import torch

from radiocore_tpu_torch.apps.iq import (IQFileSource, SyntheticFmSource,
                                         WavSink)
from radiocore_tpu_torch.models.decimate import Decimate
from radiocore_tpu_torch.models.mfm import MFM
from radiocore_tpu_torch.models.wbfm import WBFM
from radiocore_tpu_torch.runtime.config import PipelineConfig, StationConfig
from radiocore_tpu_torch.runtime.ingest import IngestPipe
from radiocore_tpu_torch.runtime.metrics import Metrics
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.profiling import StageTimer
from radiocore_tpu_torch.runtime.transfer import to_host
from radiocore_tpu_torch.tools.ringbuffer import RingBuffer

Config = PipelineConfig


def _is_stereo(config: PipelineConfig) -> bool:
    return not config.stations or config.stations[0].mode == "wbfm"


def run(config: Config, source, sink, seconds: float,
        metrics: Metrics | None = None,
        timer: StageTimer | None = None,
        ingest_depth: int = 2,
        wbfm_mode: str = "exact",
        realtime_source: bool = False,
        ring_seconds: float = 3.0,
        warmup: bool = False, *,
        device: Optional[torch.device | str] = None) -> None:
    """Pump ``seconds`` of IQ through the pipeline on ``device`` (the
    first CUDA device when None) into ``sink``.

    Host→device copies run ``ingest_depth`` chunks ahead on the card's
    copy engine (``runtime/ingest.py``). ``timer`` records per-stage wall
    times: ``ring_get`` and the host chunk's wait in the ring,
    ``decimate`` and ``demod`` the launches (the host's enqueue), and
    ``sink``, which waits on the audio, the device work of the chunk, its
    copy to the host and the sink's write.

    ``warmup`` keeps the reference's semantics: it runs one real chunk of
    the source through the pipeline before the producer starts, so that
    chunk is consumed and primes the demodulator's state.
    """
    device = resolve_device(device)
    metrics = metrics or Metrics()
    timer = timer or StageTimer()
    # The model constructors below receive chunk SIZES where the design
    # math needs sample RATES; they coincide only under the one-second
    # convention.
    if config.chunk_seconds != 1.0:
        raise ValueError(
            f"receive_fm.run requires chunk_seconds == 1.0 (got "
            f"{config.chunk_seconds}): filter design assumes chunk "
            f"length == sample rate")
    in_chunk = config.chunk_size
    # ``ring_seconds`` sizes the jitter buffer (reference default: 3 s,
    # reference: examples/receive_fm.py:39-40).
    ring = RingBuffer(int(in_chunk * ring_seconds), dtype="complex64",
                      print_overflow=False)

    decimate = Decimate(in_chunk, config.demod_chunk, device=device)
    if _is_stereo(config):
        demod = WBFM(config.demod_chunk, config.audio_chunk,
                     deemphasis=config.deemphasis, mode=wbfm_mode,
                     device=device)
    else:
        demod = MFM(config.demod_chunk, config.audio_chunk,
                    deemphasis=config.deemphasis, device=device)

    n_chunks = int(round(seconds))
    stop = threading.Event()

    if warmup:
        w = np.asarray(source.read_chunk(1.0))[:in_chunk]
        if len(w) == in_chunk:
            _ = demod.run(decimate.run(w))

    def producer():
        t0 = time.monotonic()
        for i in range(n_chunks):
            if stop.is_set():
                return
            if realtime_source:
                # Pace chunks at wall-clock rate — live-SDR semantics
                # (reference: examples/receive_fm.py:46-58).
                lag = i - (time.monotonic() - t0)
                if lag > 0:
                    time.sleep(lag)
            ring.put(source.read_chunk(1.0))
            metrics.incr("chunks_in")

    prod = threading.Thread(target=producer, daemon=True)
    prod.start()

    # The pipe copies each chunk into a page-locked slot before it takes
    # the next, so one staging buffer serves every chunk.
    pipe = IngestPipe(depth=ingest_depth, device=device)
    staging = np.empty(in_chunk, np.complex64)

    def host_chunks():
        got = 0
        while got < n_chunks:
            with timer.stage("ring_get"):
                if ring.get(staging, timeout=3.0) is None:
                    if not prod.is_alive():
                        return
                    continue
            got += 1
            yield staging

    t_start = time.monotonic()
    done = 0
    try:
        for station_iq in pipe.stream(host_chunks()):
            with timer.stage("decimate"):
                station = decimate.run(station_iq)
            with timer.stage("demod"):
                audio = demod.run(station, numpy_output=False)
            with timer.stage("sink", sync_value=audio):
                sink.write(to_host(audio))
            done += 1
            metrics.incr("chunks_out")
            metrics.gauge("ring_occupancy_pct",
                          100.0 * ring.occupancy / ring.capacity)
            metrics.gauge("ring_overflows", float(ring.overflows))
            metrics.gauge("realtime_factor",
                          done / max(time.monotonic() - t_start, 1e-9))
    finally:
        stop.set()
        prod.join(timeout=1.0)


def main(argv=None) -> None:
    """CLI entry: single-station receive to WAV/audio (see --help)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("frequency", nargs="?", type=float, default=96.9e6,
                        help="station frequency (Hz), parity with the "
                             "reference's positional argv")
    parser.add_argument("--iq-file", help="raw IQ file to play back")
    parser.add_argument("--iq-format", default="cf32",
                        choices=("cf32", "cu8", "cs8", "cs16"),
                        help="IQ file wire format (fixed-point formats "
                             "go through the native converter)")
    parser.add_argument("--soapy", metavar="DEVICE_ARGS", default=None,
                        help="use a live SoapySDR device (e.g. "
                             "'driver=rtlsdr'); requires SoapySDR")
    parser.add_argument("--play", action="store_true",
                        help="play audio live via sounddevice instead of "
                             "writing a WAV")
    parser.add_argument("--input-rate", type=float, default=2.4e6)
    parser.add_argument("--demod-rate", type=float, default=240e3)
    parser.add_argument("--audio-rate", type=float, default=48e3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--mono", action="store_true")
    parser.add_argument("--out", default="receive_fm.wav")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the first "
                             "CUDA device; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    config = PipelineConfig(
        input_rate=args.input_rate, demod_rate=args.demod_rate,
        audio_rate=args.audio_rate, center_frequency=args.frequency,
        stations=(StationConfig(args.frequency, args.demod_rate,
                                "mfm" if args.mono else "wbfm"),))

    if args.soapy is not None:
        from radiocore_tpu_torch.apps.iq import SoapySdrSource
        source = SoapySdrSource(config.input_rate, config.center_frequency,
                                device_args=args.soapy)
    elif args.iq_file:
        source = IQFileSource(args.iq_file, int(config.input_rate),
                              fmt=args.iq_format)
    else:
        source = SyntheticFmSource(int(config.input_rate), [0],
                                   int(config.demod_rate))

    metrics = Metrics()
    timer = StageTimer()
    if args.play:
        from radiocore_tpu_torch.apps.iq import AudioDeviceSink
        sink_cm = AudioDeviceSink(int(config.audio_rate),
                                  channels=2 if _is_stereo(config) else 1)
    else:
        sink_cm = WavSink(args.out, int(config.audio_rate))
    with sink_cm as sink:
        run(config, source, sink, args.seconds, metrics, timer=timer,
            device=device)
    snap = metrics.snapshot()
    dest = "audio device" if args.play else args.out
    print(f"wrote {dest}: {int(snap.get('chunks_out', 0))} s audio, "
          f"realtime x{snap.get('realtime_factor', 0):.2f} on {device}")
    stages = ", ".join(f"{k} {v['mean_ms']:.1f} ms"
                       for k, v in sorted(timer.report().items()))
    if stages:
        print(f"stage profile: {stages}")


if __name__ == "__main__":
    main()

"""Multi-station FM server (reference: ``examples/multi_fm_server.py``);
counterpart of ``radiocore_tpu/apps/multi_fm_server.py``.

Channelizes a wide band into stations, demodulates all of them on the
device, and publishes each station's audio on ZeroMQ PUB with the 4-byte
little-endian center-frequency topic
(reference: multi_fm_server.py:105-120, tuner.py:33-35).

Two loops: :func:`serve`, the Tuner path (one band FFT, all channels
extracted at once by ``Tuner.run_all``, one demodulator class per
station: ``WBFM``, ``MFM`` or ``FM``), and :func:`serve_fused`, the fused
multi-station step (``parallel/pipeline.make_multi_station_step``) fed by
an :class:`~radiocore_tpu_torch.runtime.ingest.IngestPipe`.

Run headless (no SDR, ZMQ optional; ``--device cpu`` without a card):
    python -m radiocore_tpu_torch.apps.multi_fm_server --seconds 2 --no-zmq
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from radiocore_tpu_torch.apps.iq import SyntheticFmSource, WavSink
from radiocore_tpu_torch.models.fm import FM
from radiocore_tpu_torch.models.mfm import MFM
from radiocore_tpu_torch.models.wbfm import WBFM
from radiocore_tpu_torch.runtime.ingest import IngestPipe
from radiocore_tpu_torch.runtime.metrics import Metrics
from radiocore_tpu_torch.runtime.platform import resolve_device
from radiocore_tpu_torch.runtime.profiling import StageTimer
from radiocore_tpu_torch.runtime.transfer import to_host
from radiocore_tpu_torch.tools.tuner import Tuner

DEMODS = {"fm": FM, "mfm": MFM, "wbfm": WBFM}


@dataclasses.dataclass
class StationSpec:
    frequency: float
    mode: str = "wbfm"
    bandwidth: float = 240e3


def build_tuner(stations: Sequence[StationSpec], audio_rate: float,
                request_bandwidth: Optional[float] = None, *,
                device: Optional[torch.device | str] = None) -> Tuner:
    """Register stations with demodulators on ``device`` (the first CUDA
    device when None), reference-style (reference:
    multi_fm_server.py:125-136)."""
    device = resolve_device(device)
    tuner = Tuner(device=device)
    for spec in stations:
        demod = DEMODS[spec.mode](spec.bandwidth, audio_rate, device=device)
        tuner.add_channel(spec.frequency, spec.bandwidth, demod)
    if request_bandwidth:
        tuner.request_bandwidth(request_bandwidth)
    return tuner


def serve(tuner: Tuner, source, seconds: float,
          publisher=None, sinks: Optional[List] = None,
          metrics: Optional[Metrics] = None,
          timer: Optional[StageTimer] = None) -> None:
    """Main DSP loop: load 1 s, extract all channels, demod, publish. Runs
    on the tuner's device; each demodulator's ``run`` hands back host
    audio."""
    metrics = metrics or Metrics()
    timer = timer or StageTimer()
    homogeneous = len({int(c.bandwidth) for c in tuner.channels()}) == 1
    for _ in range(int(round(seconds))):
        with timer.stage("source"):
            chunk = source.read_chunk(1.0)
        t0 = time.monotonic()
        with timer.stage("tuner_load"):
            tuner.load(chunk)
        if homogeneous:
            with timer.stage("extract_all"):
                stations_iq = tuner.run_all()
        for i, channel in enumerate(tuner.channels()):
            with timer.stage("extract"):
                iq = stations_iq[i] if homogeneous else tuner.run(i)
            with timer.stage("demod"):
                audio = channel.demodulator.run(iq)
            with timer.stage("publish"):
                if publisher is not None:
                    publisher.send_multipart(
                        [channel.address_bytes,
                         np.ascontiguousarray(audio, np.float32).tobytes()])
                if sinks:
                    sinks[i].write(audio)
        metrics.incr("chunks")
        metrics.gauge("chunk_seconds", time.monotonic() - t0)


def serve_fused(specs: Sequence[StationSpec], band_rate: float,
                audio_rate: float, source, seconds: float,
                publisher=None, sinks: Optional[List] = None,
                metrics: Optional[Metrics] = None,
                mode: str = "fast",
                timer: Optional[StageTimer] = None, *,
                device: Optional[torch.device | str] = None) -> None:
    """All-WBFM serving through the fused multi-station step on
    ``device`` (the first CUDA device when None): band FFT → all-station
    extraction → batched WBFM (``parallel/pipeline.py``). Requires
    homogeneous WBFM stations.

    Stages: ``source`` (the host read), ``fused_step`` (the step's
    launches, the host's enqueue), ``fetch`` (waits on the audio, so the
    step's device time, and copies it to the host) and ``publish``. The
    pipe's host memcpy of each chunk into its page-locked slot, and the
    launch of its copy, fall between the stages.
    """
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step

    device = resolve_device(device)
    metrics = metrics or Metrics()
    timer = timer or StageTimer()
    n_band = int(band_rate)
    center = (min(s.frequency for s in specs) +
              max(s.frequency for s in specs)) / 2
    offsets = [int(s.frequency - center) for s in specs]
    bw = int(specs[0].bandwidth)
    step, state = make_multi_station_step(
        n_band, offsets, bw, int(audio_rate), mode=mode, device=device)
    topics = [int(s.frequency).to_bytes(4, "little") for s in specs]

    pipe = IngestPipe(depth=2, device=device)  # chunk N+1's copy overlaps N

    def host_chunks():
        for _ in range(int(round(seconds))):
            with timer.stage("source"):
                chunk = source.read_chunk(1.0)
            yield chunk

    for band in pipe.stream(host_chunks()):
        t0 = time.monotonic()
        with timer.stage("fused_step"):
            audio_all, state = step(band, state)
        with timer.stage("fetch", sync_value=audio_all):
            audio_np = to_host(audio_all)
        with timer.stage("publish"):
            for i, topic in enumerate(topics):
                if publisher is not None:
                    publisher.send_multipart(
                        [topic, np.ascontiguousarray(
                            audio_np[i], np.float32).tobytes()])
                if sinks:
                    sinks[i].write(audio_np[i])
        metrics.incr("chunks")
        metrics.gauge("chunk_seconds", time.monotonic() - t0)


def main(argv=None) -> None:
    """CLI entry: serve N stations as ZMQ PUB topics (see --help)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--stations", type=int, default=3)
    parser.add_argument("--band-rate", type=float, default=10e6,
                        help="requested SDR bandwidth "
                             "(reference: multi_fm_server.py:136)")
    parser.add_argument("--bandwidth", type=float, default=240e3)
    parser.add_argument("--audio-rate", type=float, default=48e3)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--bind", default="tcp://*:5555")
    parser.add_argument("--no-zmq", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="all-WBFM fused multi-station step "
                             "(batched channelize+demod)")
    parser.add_argument("--wav-prefix", default=None,
                        help="also write each station to PREFIX_<i>.wav")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the first "
                             "CUDA device; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    base = 96.9e6
    modes = ["wbfm"] * 3 if args.fused else ["wbfm", "mfm", "fm"]
    specs = [StationSpec(base + i * 400e3,
                         modes[i % 3], args.bandwidth)
             for i in range(args.stations)]
    tuner = build_tuner(specs, args.audio_rate, args.band_rate,
                        device=device)

    n_band = int(tuner.input_bandwidth)
    offsets = [int(s.frequency - tuner.input_frequency) for s in specs]
    source = SyntheticFmSource(n_band, offsets, int(args.bandwidth))

    publisher = None
    if not args.no_zmq:
        import zmq
        ctx = zmq.Context()
        publisher = ctx.socket(zmq.PUB)
        publisher.bind(args.bind)

    sinks = None
    if args.wav_prefix:
        sinks = [WavSink(f"{args.wav_prefix}_{i}.wav", int(args.audio_rate))
                 for i in range(len(specs))]

    metrics = Metrics()
    timer = StageTimer()
    try:
        if args.fused:
            serve_fused(specs, tuner.input_bandwidth, args.audio_rate,
                        source, args.seconds, publisher, sinks, metrics,
                        timer=timer, device=device)
        else:
            serve(tuner, source, args.seconds, publisher, sinks, metrics,
                  timer=timer)
    finally:
        if sinks:
            for s in sinks:
                s.close()
        if publisher is not None:
            publisher.close()
    snap = metrics.snapshot()
    print(f"served {int(snap['chunks'])} chunks x {len(specs)} stations "
          f"on {device}, last chunk {snap['chunk_seconds']:.3f}s")
    stages = ", ".join(f"{k} {v['mean_ms']:.1f} ms"
                       for k, v in sorted(timer.report().items()))
    if stages:
        print(f"stage profile: {stages}")


if __name__ == "__main__":
    main()

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

``main`` reads the JAX package's routing variables once
(``Routes.from_environ``), prints them and hands them to the loop; with
``--fused`` it also takes ``RADIOCORE_TPU_EXTRACT_DEMOD`` (``off``,
``fused`` or ``spec``) as the fused step's ``extract_demod``. The fused
extract+demod kernels decode WBFM only, so ``fused`` and ``spec`` serve
``--stations 1`` (station 0 is WBFM); with more stations, whose modes
rotate WBFM, MFM, FM, ``main`` refuses them before it builds anything.

``--fused --band-centers F1,F2,...`` serves several bands of
``--band-rate`` side by side (the upstream's fixed-rate SDR, one a band)
in one step: ``--stations`` WBFM stations a band, 400 kHz apart about
each centre, each band from its own source, every station under its own
topic.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
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
from radiocore_tpu_torch.runtime.routes import Routes
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
                device: Optional[torch.device | str] = None,
                routes: Optional[Routes] = None) -> Tuner:
    """Register stations with demodulators on ``device`` (the first CUDA
    device when None), reference-style (reference:
    multi_fm_server.py:125-136); the tuner and every demodulator take
    ``routes`` (None: the defaults)."""
    device = resolve_device(device)
    tuner = Tuner(device=device, routes=routes)
    for spec in stations:
        demod = DEMODS[spec.mode](spec.bandwidth, audio_rate, device=device,
                                  routes=routes)
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
                device: Optional[torch.device | str] = None,
                routes: Optional[Routes] = None,
                extract_demod: str = "off", pll: str = "analytic",
                centers: Optional[Sequence[float]] = None) -> None:
    """Serving through the fused multi-station step on ``device`` (the
    first CUDA device when None): band FFT → all-station extraction →
    each station's demodulator, batched by kind (``parallel/pipeline.py``,
    ``kinds`` from each spec's ``mode``). Every spec must have the same
    ``bandwidth`` (the step's one station chunk); a ``ValueError`` says
    otherwise. Each station is published under its topic with its kind's
    channels: WBFM ``(audio, 2)``, MFM and FM ``(audio,)`` (the bytes of
    the upstream's ``(N, 1)``); a sink gets ``(audio, 2)`` or
    ``(audio, 1)``, as from the Tuner path's classes.

    Stages: ``source`` (the host read), ``fused_step`` (the step's
    launches, the host's enqueue), ``fetch`` (waits on the audio, so the
    step's device time, and copies it to the host) and ``publish``. The
    pipe's host memcpy of each chunk into its page-locked slot, and the
    launch of its copy, fall between the stages. ``routes``,
    ``extract_demod`` (``"off"`` unless every station is WBFM) and
    ``pll`` (``"nco"``, the feedback pilot loop, with ``mode="exact"``)
    go to ``make_multi_station_step``; ``mode`` and ``pll`` are the WBFM
    stations'.

    ``centers`` serves several bands of ``band_rate`` at once (receivers
    side by side, the step's ``bands``): band b is centred at
    ``centers[b]``, and each spec belongs to the band whose centre is
    nearest. ``source`` is then a list of sources, one a band, each read
    one chunk a step. Every station is WBFM (a batch of bands takes no
    mix). ``ValueError`` refuses a source whose own ``band_rate`` or
    ``sample_rate`` is not ``band_rate``, and sources that fall out of
    step (a chunk of another length than ``band_rate``);
    ``make_multi_station_step`` refuses a station whose channel leaves
    its band and a band with no station.
    """
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step

    device = resolve_device(device)
    metrics = metrics or Metrics()
    timer = timer or StageTimer()
    widths = sorted({int(s.bandwidth) for s in specs})
    if len(widths) != 1:
        raise ValueError(f"serve_fused takes one station bandwidth for "
                         f"every spec (the step's station chunk); got "
                         f"{widths}")
    n_band = int(band_rate)
    if centers is None:
        center = (min(s.frequency for s in specs) +
                  max(s.frequency for s in specs)) / 2
        offsets = [int(s.frequency - center) for s in specs]
        step, state = make_multi_station_step(
            n_band, offsets, widths[0], int(audio_rate), mode=mode,
            extract_demod=extract_demod, pll=pll,
            kinds=[s.mode for s in specs], device=device, routes=routes)
        # Station i's row: (kind, row in its kind's audio). All WBFM: one
        # tensor in station order.
        rows = getattr(step, "rows", {"wbfm": range(len(specs))})
        read = source.read_chunk
    else:
        order, plans = _band_plan(specs, n_band, centers, source)
        step, state = make_multi_station_step(
            n_band, None, widths[0], int(audio_rate), mode=mode,
            extract_demod=extract_demod, pll=pll, bands=plans,
            device=device, routes=routes)
        rows = {"wbfm": order}
        read = _bands_reader(source, len(plans), n_band)
    topics = [int(s.frequency).to_bytes(4, "little") for s in specs]
    where = {i: (kind, j) for kind, idx in rows.items()
             for j, i in enumerate(idx)}

    pipe = IngestPipe(depth=2, device=device)  # chunk N+1's copy overlaps N

    def host_chunks():
        for _ in range(int(round(seconds))):
            with timer.stage("source"):
                chunk = read(1.0)
            yield chunk

    for band in pipe.stream(host_chunks()):
        t0 = time.monotonic()
        with timer.stage("fused_step"):
            audio_all, state = step(band, state)
        with timer.stage("fetch", sync_value=audio_all):
            if not isinstance(audio_all, dict):
                audio_all = {"wbfm": audio_all}
            audio_np = {kind: to_host(a) for kind, a in audio_all.items()}
        with timer.stage("publish"):
            for i, topic in enumerate(topics):
                kind, j = where[i]
                audio = audio_np[kind][j]
                if publisher is not None:
                    publisher.send_multipart(
                        [topic, np.ascontiguousarray(
                            audio, np.float32).tobytes()])
                if sinks:
                    sinks[i].write(audio if audio.ndim == 2
                                   else audio[:, None])
        metrics.incr("chunks")
        metrics.gauge("chunk_seconds", time.monotonic() - t0)


def _band_plan(specs: Sequence[StationSpec], n_band: int,
               centers: Sequence[float], sources):
    """``(order, plans)`` of a batch of bands: the spec index of each step
    row (band after band), and each band's offsets from its centre.
    Refuses a source of another rate than the bands' and a station that
    is not WBFM."""
    rates = {int(r) for r in (getattr(src, "band_rate",
                                      getattr(src, "sample_rate", n_band))
                              for src in sources)}
    if rates != {n_band}:
        raise ValueError(f"bands of unequal rate {sorted(rates | {n_band})}"
                         f": one step takes bands of one rate")
    members = [[] for _ in centers]
    for i, spec in enumerate(specs):
        if spec.mode != "wbfm":
            raise ValueError(f"the station at {spec.frequency / 1e6:.4f} "
                             f"MHz is {spec.mode!r}: a batch of bands "
                             f"decodes WBFM only")
        b = min(range(len(centers)),
                key=lambda k: abs(spec.frequency - centers[k]))
        members[b].append((i, int(round(spec.frequency - centers[b]))))
    order = [i for m in members for i, _ in m]
    return order, [[off for _, off in m] for m in members]


def _bands_reader(sources, n_bands: int, n_band: int):
    """``read(seconds) -> (B, n_band)``: one chunk of every band, one
    source a band; a chunk of another length raises ``ValueError`` (the
    sources fell out of step)."""
    if len(sources) != n_bands:
        raise ValueError(f"{len(sources)} sources for {n_bands} bands")

    def read(seconds: float) -> np.ndarray:
        out = np.empty((n_bands, n_band), np.complex64)
        for b, src in enumerate(sources):
            chunk = np.asarray(src.read_chunk(seconds))
            if chunk.shape != (n_band,):
                raise ValueError(f"source {b} gave {chunk.shape[-1]} "
                                 f"samples where the others give {n_band}: "
                                 f"the bands fell out of step")
            out[b] = chunk
        return out
    return read


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
                        help="fused multi-station step (one "
                             "channelization, each kind's demodulator "
                             "batched)")
    parser.add_argument("--pll", choices=("analytic", "nco"),
                        default="analytic",
                        help="the fused step's pilot tracker: 'nco' runs "
                             "the exact tail with the feedback loop")
    parser.add_argument("--band-centers", default=None,
                        help="with --fused: comma-separated centres (Hz) "
                             "of bands of --band-rate served side by side "
                             "in one step, --stations WBFM stations a "
                             "band")
    parser.add_argument("--wav-prefix", default=None,
                        help="also write each station to PREFIX_<i>.wav")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the first "
                             "CUDA device; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    routes = Routes.from_environ()
    extract_demod = os.environ.get("RADIOCORE_TPU_EXTRACT_DEMOD", "off")
    print(f"routes: {routes}" + (f", extract_demod={extract_demod}"
                                 if args.fused else ""))
    centers = None
    if args.band_centers is not None:
        if not args.fused:
            parser.error("--band-centers serves bands side by side through "
                         "the fused step: add --fused")
        # --stations WBFM stations a band, 400 kHz apart about its centre,
        # each band from its own source.
        centers = [float(f) for f in args.band_centers.split(",")]
        band_rate = args.band_rate
        plan = [int((2 * i - (args.stations - 1)) * 200e3)
                for i in range(args.stations)]
        specs = [StationSpec(c + off, "wbfm", args.bandwidth)
                 for c in centers for off in plan]
        source = [SyntheticFmSource(int(band_rate), plan,
                                    int(args.bandwidth), seed=b)
                  for b in range(len(centers))]
    else:
        base = 96.9e6
        modes = ["wbfm", "mfm", "fm"]
        specs = [StationSpec(base + i * 400e3,
                             modes[i % 3], args.bandwidth)
                 for i in range(args.stations)]
        if (args.fused and extract_demod != "off"
                and any(s.mode != "wbfm" for s in specs)):
            parser.error(f"RADIOCORE_TPU_EXTRACT_DEMOD={extract_demod} "
                         f"decodes WBFM only, and --stations "
                         f"{args.stations} serves WBFM, MFM and FM in "
                         f"rotation: use --stations 1, or leave the "
                         f"variable unset ('off')")
        tuner = build_tuner(specs, args.audio_rate, args.band_rate,
                            device=device, routes=routes)
        band_rate = tuner.input_bandwidth
        offsets = [int(s.frequency - tuner.input_frequency) for s in specs]
        source = SyntheticFmSource(int(band_rate), offsets,
                                   int(args.bandwidth))

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
            serve_fused(specs, band_rate, args.audio_rate,
                        source, args.seconds, publisher, sinks, metrics,
                        mode="exact" if args.pll == "nco" else "fast",
                        timer=timer, device=device, routes=routes,
                        extract_demod=extract_demod, pll=args.pll,
                        centers=centers)
        else:
            serve(tuner, source, args.seconds, publisher, sinks, metrics,
                  timer=timer)
    finally:
        if sinks:
            for s in sinks:
                s.close()
        if publisher is not None:
            publisher.close()
    if centers:
        print(f"bands: {len(centers)} of {int(band_rate)} S/s centred at "
              + ", ".join(f"{c / 1e6:.4f}" for c in centers) + " MHz")
    snap = metrics.snapshot()
    print(f"served {int(snap['chunks'])} chunks x {len(specs)} stations "
          f"on {device}, last chunk {snap['chunk_seconds']:.3f}s")
    stages = ", ".join(f"{k} {v['mean_ms']:.1f} ms"
                       for k, v in sorted(timer.report().items()))
    if stages:
        print(f"stage profile: {stages}")


if __name__ == "__main__":
    main()

"""Multi-station FM client (reference: ``examples/multi_fm_receiver.py``);
a copy of ``radiocore_tpu/apps/multi_fm_receiver.py`` (host and ZeroMQ
only, no device).

Subscribes to one station's 4-byte little-endian frequency topic on a
ZeroMQ SUB socket, reassembles float32 audio frames, and writes them to
a WAV file (or sounddevice when installed)
(reference: multi_fm_receiver.py:20-50).

    python -m radiocore_tpu_torch.apps.multi_fm_receiver 96.9e6 --seconds 2
"""

from __future__ import annotations

import argparse

import numpy as np

from radiocore_tpu_torch.apps.iq import WavSink


def receive(frequency: float, connect: str, seconds: float,
            channels: int, audio_rate: int, sink) -> int:
    """Subscribe to one station topic and write its audio to WAV."""
    import zmq
    ctx = zmq.Context()
    sock = ctx.socket(zmq.SUB)
    sock.connect(connect)
    topic = int(frequency).to_bytes(4, byteorder="little")
    sock.setsockopt(zmq.SUBSCRIBE, topic)
    sock.setsockopt(zmq.RCVTIMEO, 5000)

    got = 0
    try:
        while got < int(round(seconds)):
            try:
                _, payload = sock.recv_multipart()
            except zmq.Again:
                break
            audio = np.frombuffer(payload, np.float32).reshape(-1, channels)
            sink.write(audio)
            got += 1
    finally:
        sock.close()
        ctx.term()
    return got


def main(argv=None) -> None:
    """CLI entry (see --help)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("frequency", type=float)
    parser.add_argument("--connect", default="tcp://localhost:5555")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--channels", type=int, default=2)
    parser.add_argument("--audio-rate", type=int, default=48000)
    parser.add_argument("--out", default="station.wav")
    args = parser.parse_args(argv)

    with WavSink(args.out, args.audio_rate) as sink:
        got = receive(args.frequency, args.connect, args.seconds,
                      args.channels, args.audio_rate, sink)
    print(f"received {got} chunks -> {args.out}")


if __name__ == "__main__":
    main()

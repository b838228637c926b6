"""The port's apps against ``tests/test_apps.py``: synthetic source →
demod → WAV, the CLIs with ``--device cpu``, the ZeroMQ loopback, the IQ
formats, and ``receive_fm.run``, ``serve`` and ``serve_fused`` against
the JAX apps on the same source seed (float audio captured by a list
sink, 4e-5 abs), on the CPU."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import oracles
from radiocore_tpu.apps import iq as jiq
from radiocore_tpu.apps import multi_fm_server as jsrv
from radiocore_tpu.apps import receive_fm as jrx
from radiocore_tpu_torch.apps import multi_fm_server as srv
from radiocore_tpu_torch.apps import receive_fm as rx
from radiocore_tpu_torch.apps.iq import (IQFileSource, SyntheticFmSource,
                                         WavSink, convert_iq, write_iq_file)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ATOL = 4e-5      # the port's audio against the JAX app's
ZMQ_PORT = 15593  # apart from the JAX test's 15591


class ListSink:
    """Keeps every chunk of float audio it is given."""

    def __init__(self):
        self.chunks = []

    def write(self, audio):
        self.chunks.append(np.array(audio, dtype=np.float32, copy=True))

    def close(self):
        pass


def _assert_same_audio(mine, theirs):
    assert len(mine.chunks) == len(theirs.chunks) > 0
    for a, b in zip(mine.chunks, theirs.chunks):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_synthetic_source_matches_jax():
    """The copy of the source gives the JAX source's chunks bit for bit."""
    mine = SyntheticFmSource(100_000, [-20_000, 20_000], 25_000, seed=3)
    theirs = jiq.SyntheticFmSource(100_000, [-20_000, 20_000], 25_000,
                                   seed=3)
    for _ in range(2):
        np.testing.assert_array_equal(mine.read_chunk(), theirs.read_chunk())


def test_synthetic_source_demodulates(tmp_path):
    """SyntheticFmSource → Decimate → WBFM recovers the station's tones."""
    out = tmp_path / "rx.wav"
    cfg = rx.Config(input_rate=200e3, demod_rate=50e3, audio_rate=10e3)
    source = SyntheticFmSource(200_000, [0], 50_000, tones=[(440.0, 880.0)])
    metrics = rx.Metrics()
    with WavSink(str(out), 10_000) as sink:
        rx.run(cfg, source, sink, seconds=2, metrics=metrics, device="cpu")
    rate, audio = wavfile.read(out)
    assert rate == 10_000 and audio.shape == (20_000, 2)
    a = audio.astype(np.float32) / 32767
    assert oracles.tone_snr_db(a[11000:-500, 0], 10_000, 440.0) > 10
    assert oracles.tone_snr_db(a[11000:-500, 1], 10_000, 880.0) > 10
    assert metrics.snapshot()["chunks_out"] == 2


@pytest.mark.parametrize("mono", [False, True])
def test_receive_fm_run_matches_jax(mono):
    """``receive_fm.run`` (ring, producer thread, ingest pipe, Decimate,
    WBFM or MFM) against the JAX app on the same source seed."""
    mode = "mfm" if mono else "wbfm"
    cfg = rx.Config(input_rate=200e3, demod_rate=50e3, audio_rate=10e3,
                    stations=(rx.StationConfig(0.0, 50e3, mode),))
    jcfg = jrx.Config(input_rate=200e3, demod_rate=50e3, audio_rate=10e3,
                      stations=(jrx.StationConfig(0.0, 50e3, mode),))
    sinks = ListSink(), ListSink()
    timer = rx.StageTimer()
    rx.run(cfg, SyntheticFmSource(200_000, [0], 50_000, seed=4), sinks[0],
           seconds=2, timer=timer, device="cpu")
    jrx.run(jcfg, jiq.SyntheticFmSource(200_000, [0], 50_000, seed=4),
            sinks[1], seconds=2)
    _assert_same_audio(*sinks)
    assert sinks[0].chunks[0].shape == ((10_000, 1) if mono else (10_000, 2))
    assert set(timer.report()) == {"ring_get", "decimate", "demod", "sink"}


def test_receive_fm_cli(tmp_path, capsys):
    out = tmp_path / "cli.wav"
    rx.main(["--input-rate", "200e3", "--demod-rate", "50e3",
             "--audio-rate", "10e3", "--seconds", "1",
             "--out", str(out), "--device", "cpu"])
    assert os.path.exists(out)
    printed = capsys.readouterr().out
    assert "realtime" in printed and "on cpu" in printed


def test_clis_without_card_raise(tmp_path):
    """Without ``--device`` the apps run on the card, and without one they
    raise; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        rx.main(["--seconds", "1", "--out", str(tmp_path / "x.wav")])
    with pytest.raises(RuntimeError, match="CUDA device"):
        srv.main(["--no-zmq", "--seconds", "1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        rx.run(rx.Config(input_rate=200e3, demod_rate=50e3,
                         audio_rate=10e3), None, ListSink(), 1)


def test_apps_run_as_modules():
    """``python -m radiocore_tpu_torch.apps.<name>`` reaches each CLI."""
    code = ("import runpy, sys\n"
            "for m in ('receive_fm', 'multi_fm_server', "
            "'multi_fm_receiver'):\n"
            "    sys.argv = [m, '--help']\n"
            "    try:\n"
            "        runpy.run_module('radiocore_tpu_torch.apps.' + m,\n"
            "                         run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (m, e.code)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--device", "--fused", "--connect"):
        assert flag in proc.stdout


def test_iq_file_source_roundtrip(tmp_path):
    path = tmp_path / "capture.cf32"
    iq = (np.arange(1000) + 1j * np.arange(1000)).astype(np.complex64)
    write_iq_file(str(path), iq)
    src = IQFileSource(str(path), 400)
    chunk = src.read_chunk(1.0)
    np.testing.assert_array_equal(chunk, iq[:400])
    chunk2 = src.read_chunk(2.0)  # crosses the loop boundary
    np.testing.assert_array_equal(chunk2[:600], iq[400:])
    np.testing.assert_array_equal(chunk2[600:], iq[:200])


def test_multi_fm_server_headless(tmp_path, capsys):
    prefix = str(tmp_path / "st")
    srv.main(["--stations", "2", "--band-rate", "1e6",
              "--bandwidth", "50e3", "--audio-rate", "10e3",
              "--seconds", "1", "--no-zmq", "--wav-prefix", prefix,
              "--device", "cpu"])
    assert "served 1 chunks" in capsys.readouterr().out
    r0, a0 = wavfile.read(prefix + "_0.wav")
    assert r0 == 10_000 and a0.shape[0] == 10_000
    a = a0.astype(np.float32) / 32767
    assert oracles.tone_snr_db(a[2000:, 0], 10_000, 300.0) > 6


def test_multi_fm_server_fused(tmp_path, capsys):
    prefix = str(tmp_path / "fu")
    srv.main(["--stations", "2", "--band-rate", "1e6",
              "--bandwidth", "50e3", "--audio-rate", "10e3",
              "--seconds", "1", "--no-zmq", "--fused",
              "--wav-prefix", prefix, "--device", "cpu"])
    assert "served 1 chunks" in capsys.readouterr().out
    r0, a0 = wavfile.read(prefix + "_0.wav")
    assert r0 == 10_000 and a0.shape == (10_000, 2)  # stereo WBFM
    a = a0.astype(np.float32) / 32767
    assert oracles.tone_snr_db(a[2000:, 0], 10_000, 300.0) > 6


def _specs(module, modes):
    return [module.StationSpec(96.9e6 + i * 400e3, mode, 50e3)
            for i, mode in enumerate(modes)]


def test_serve_matches_jax():
    """The Tuner path with one WBFM, one MFM and one FM class against the
    JAX server, two chunks of a 1 MHz band."""
    modes = ("wbfm", "mfm", "fm")
    tuner = srv.build_tuner(_specs(srv, modes), 10e3, 1e6, device="cpu")
    jtuner = jsrv.build_tuner(_specs(jsrv, modes), 10e3, 1e6)
    n_band = int(tuner.input_bandwidth)
    assert n_band == int(jtuner.input_bandwidth) == 1_000_000
    offsets = [int(c.center_frequency - tuner.input_frequency)
               for c in tuner.channels()]
    sinks = [ListSink() for _ in modes], [ListSink() for _ in modes]
    timer = srv.StageTimer()
    srv.serve(tuner, SyntheticFmSource(n_band, offsets, 50_000, seed=2), 2,
              sinks=sinks[0], timer=timer)
    jsrv.serve(jtuner, jiq.SyntheticFmSource(n_band, offsets, 50_000,
                                             seed=2), 2, sinks=sinks[1])
    for mine, theirs in zip(*sinks):
        _assert_same_audio(mine, theirs)
    assert [s.chunks[0].shape for s in sinks[0]] == [(10_000, 2),
                                                     (10_000, 1),
                                                     (10_000, 1)]
    assert {"source", "tuner_load", "extract_all", "extract", "demod",
            "publish"} == set(timer.report())


def test_serve_fused_matches_jax():
    """The fused step behind the ingest pipe against the JAX server, two
    chained chunks of a 1 MHz band with two WBFM stations."""
    specs, jspecs = _specs(srv, ("wbfm", "wbfm")), _specs(jsrv,
                                                          ("wbfm", "wbfm"))
    tuner = srv.build_tuner(specs, 10e3, 1e6, device="cpu")
    n_band = int(tuner.input_bandwidth)
    offsets = [int(s.frequency - tuner.input_frequency) for s in specs]
    sinks = [ListSink(), ListSink()], [ListSink(), ListSink()]
    timer = srv.StageTimer()
    metrics = srv.Metrics()
    srv.serve_fused(specs, n_band, 10e3,
                    SyntheticFmSource(n_band, offsets, 50_000, seed=6), 2,
                    sinks=sinks[0], metrics=metrics, timer=timer,
                    device="cpu")
    jsrv.serve_fused(jspecs, n_band, 10e3,
                     jiq.SyntheticFmSource(n_band, offsets, 50_000, seed=6),
                     2, sinks=sinks[1])
    for mine, theirs in zip(*sinks):
        _assert_same_audio(mine, theirs)
    assert metrics.snapshot()["chunks"] == 2
    assert set(timer.report()) == {"source", "fused_step", "fetch",
                                   "publish"}


def test_zmq_pub_sub_loopback(tmp_path):
    zmq = pytest.importorskip("zmq")
    from radiocore_tpu_torch.apps import multi_fm_receiver as rcv

    specs = [srv.StationSpec(96.9e6, "wbfm", 50e3)]
    tuner = srv.build_tuner(specs, 10e3, request_bandwidth=500e3,
                            device="cpu")
    n_band = int(tuner.input_bandwidth)
    source = SyntheticFmSource(n_band, [0], 50_000, tones=[(440.0, 880.0)])

    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.bind(f"tcp://*:{ZMQ_PORT}")

    out = tmp_path / "sub.wav"
    sink = WavSink(str(out), 10_000)
    result = {}

    def client():
        result["got"] = rcv.receive(96.9e6, f"tcp://localhost:{ZMQ_PORT}",
                                    seconds=2, channels=2,
                                    audio_rate=10_000, sink=sink)

    thread = threading.Thread(target=client)
    thread.start()
    time.sleep(0.5)  # let SUB connect (PUB drops pre-connect messages)
    try:
        srv.serve(tuner, source, seconds=2, publisher=pub)
    finally:
        pub.close()
        ctx.term()
    thread.join(timeout=10)
    assert not thread.is_alive()
    sink.close()
    assert result["got"] == 2
    rate, audio = wavfile.read(out)
    assert rate == 10_000 and audio.shape == (20_000, 2)


class TestIqFormats:
    """The port's native IQ converter (its own iqconvert.cpp) against
    NumPy math and the JAX package's converter."""

    @pytest.mark.parametrize("fmt,dtype,lo,hi,oracle", [
        ("cu8", np.uint8, 0, 256,
         lambda r: (r.astype(np.float32) - 127.5) / 127.5),
        ("cs8", np.int8, -128, 128, lambda r: r.astype(np.float32) / 128.0),
        ("cs16", np.int16, -32768, 32768,
         lambda r: r.astype(np.float32) / 32768.0),
    ])
    def test_convert_matches_numpy_and_jax(self, fmt, dtype, lo, hi, oracle):
        raw = np.random.default_rng(7).integers(lo, hi, 4096).astype(dtype)
        got = convert_iq(raw, fmt)
        want = oracle(raw).view(np.complex64)
        assert got.dtype == np.complex64
        # 1 ULP: the native kernel multiplies by the reciprocal.
        np.testing.assert_allclose(got.view(np.float32),
                                   want.view(np.float32),
                                   rtol=1.2e-7, atol=0, err_msg=fmt)
        np.testing.assert_array_equal(got, jiq.convert_iq(raw, fmt))

    def test_native_path_is_used_when_available(self):
        from radiocore_tpu_torch.native.build import (iq_convert_native,
                                                      iq_native_available)
        if not iq_native_available():
            pytest.skip("no C++ toolchain")
        raw = np.arange(0, 256, dtype=np.uint8)
        f32 = iq_convert_native(raw, "cu8")
        np.testing.assert_allclose(
            f32, (raw.astype(np.float32) - 127.5) / 127.5,
            rtol=1.2e-7, atol=0)

    def test_file_source_fixed_point(self, tmp_path):
        rng = np.random.default_rng(3)
        wire = rng.integers(-32768, 32768, 800).astype(np.int16)
        path = tmp_path / "capture.cs16"
        wire.tofile(path)
        src = IQFileSource(str(path), 400, fmt="cs16")
        chunk = src.read_chunk(1.0)
        want = (wire.astype(np.float32) / 32768.0).view(np.complex64)
        np.testing.assert_array_equal(chunk, want)

    def test_cs16_recording_roundtrip(self, tmp_path):
        iq = (np.linspace(-0.9, 0.9, 256)
              + 1j * np.linspace(0.9, -0.9, 256)).astype(np.complex64)
        path, jpath = tmp_path / "rec.cs16", tmp_path / "jrec.cs16"
        write_iq_file(str(path), iq, fmt="cs16")
        jiq.write_iq_file(str(jpath), iq, fmt="cs16")
        assert path.read_bytes() == jpath.read_bytes()
        back = IQFileSource(str(path), 256, fmt="cs16").read_chunk(1.0)
        # scale skew (32767 enc / 32768 dec) + 0.5 LSB rounding
        np.testing.assert_allclose(back.view(np.float32),
                                   iq.view(np.float32), atol=1.5 / 32768)

    def test_unknown_format_rejected(self, tmp_path):
        path = tmp_path / "x.bin"
        np.zeros(4, np.int16).tofile(path)
        with pytest.raises(ValueError, match="unknown IQ format"):
            IQFileSource(str(path), 2, fmt="cs32")
        with pytest.raises(ValueError, match="unsupported recording"):
            write_iq_file(str(path), np.zeros(2, np.complex64), fmt="cu8")

    def test_native_rejects_wrong_dtype(self):
        from radiocore_tpu_torch.native.build import (iq_convert_native,
                                                      iq_native_available)
        if not iq_native_available():
            pytest.skip("no C++ toolchain")
        with pytest.raises(TypeError, match="expects dtype"):
            iq_convert_native(np.zeros(8, np.uint8), "cs16")

    def test_convert_trims_odd_scalar_count(self):
        out = convert_iq(np.zeros(7, np.int16), "cs16")
        assert out.shape == (3,) and out.dtype == np.complex64


def test_receive_fm_warmup_and_ring_seconds():
    """The streaming knobs: pipeline-priming warmup (which, as in the
    reference, consumes one real chunk of the source) and the jitter
    buffer's depth run end to end and deliver every chunk."""
    from radiocore_tpu_torch.runtime.config import (PipelineConfig,
                                                    StationConfig)
    from radiocore_tpu_torch.runtime.metrics import Metrics

    config = PipelineConfig(input_rate=131072, demod_rate=65536,
                            audio_rate=16384,
                            stations=(StationConfig(frequency=0.0,
                                                    mode="wbfm"),))
    source = SyntheticFmSource(131072, [0], 65536)
    sink = ListSink()
    metrics = Metrics()
    rx.run(config, source, sink, seconds=2.0, metrics=metrics,
           wbfm_mode="fast", ring_seconds=5.0, warmup=True, device="cpu")
    assert len(sink.chunks) == 2
    assert sink.chunks[0].shape == (16384, 2)
    snap = metrics.snapshot()
    assert snap.get("ring_overflows", 0) == 0
    assert snap["chunks_in"] == snap["chunks_out"] == 2

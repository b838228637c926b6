"""The port's ``Routes`` against the JAX package's routing variables, on
the CPU: the defaults, the parsing, the route table of ``ops/fft``, the
four-step transforms of ``extract_ifft="fourstep"``, every ``extract_ifft`` lowering of the extractor
and every route of the ``fast`` multi-station step, each held to the JAX
package run with the same variable set (its Pallas kernels in interpret
mode, as its own tests run them)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(2)

VARS = ("RADIOCORE_TPU_FFT_PALLAS_MIN", "RADIOCORE_TPU_FFT_MIXED_MIN",
        "RADIOCORE_TPU_EXTRACT_IFFT", "RADIOCORE_TPU_STATION_RFFT",
        "RADIOCORE_TPU_ENV_FFT", "RADIOCORE_TPU_FIR_IMPL")
REL_L2 = 1e-5
ATOL = 4e-5          # audio, as tests/test_pipeline_pallas.py


@pytest.fixture
def clean_env(monkeypatch):
    """No routing variable set, and the reference's extractor cache empty
    before and after (it reads its variable when it builds)."""
    from radiocore_tpu.ops import channelize as jch
    for var in VARS + ("RADIOCORE_TPU_EXTRACT_DEMOD",):
        monkeypatch.delenv(var, raising=False)
    jch.make_extractor.cache_clear()
    yield monkeypatch
    jch.make_extractor.cache_clear()


def _rel_l2(got, want, axis=None):
    got, want = np.asarray(got), np.asarray(want)
    return (np.linalg.norm(got - want, axis=axis)
            / np.linalg.norm(want, axis=axis))


def _crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---- the object ---------------------------------------------------------

def test_defaults_are_the_references(clean_env):
    from radiocore_tpu.ops import fft as jfft
    from radiocore_tpu_torch.runtime.routes import Routes
    r = Routes()
    assert r.fft_kernel_min == jfft._pallas_min() == 1 << 24
    assert r.fft_mixed_min == jfft._mixed_min() == 1 << 23
    # The reference's inline defaults (channelize.py, pipeline.py,
    # wbfm.py, fir.py).
    assert (r.extract_ifft, r.station_rfft, r.env_fft, r.fir_impl) == (
        "auto", "auto", "native", "pallas")
    assert Routes.from_environ({}) == r == Routes.from_environ()
    assert hash(r) == hash(Routes())


@pytest.mark.parametrize("raw", ["65536", "6.5e4", "0", "-3", "1e9", "12.7"])
@pytest.mark.parametrize("var,field", [
    ("RADIOCORE_TPU_FFT_PALLAS_MIN", "fft_kernel_min"),
    ("RADIOCORE_TPU_FFT_MIXED_MIN", "fft_mixed_min"),
])
def test_thresholds_parse_as_the_reference(clean_env, var, field, raw):
    """``int(float(v))``; 0 or less disables (the reference: 2^62)."""
    from radiocore_tpu.ops import fft as jfft
    from radiocore_tpu_torch.runtime.routes import Routes
    clean_env.setenv(var, raw)
    got = getattr(Routes.from_environ(), field)
    want = (jfft._pallas_min() if field == "fft_kernel_min"
            else jfft._mixed_min())
    assert got == (0 if want == 1 << 62 else want)
    assert got == max(int(float(raw)), 0)


@pytest.mark.parametrize("var,field,values", [
    ("RADIOCORE_TPU_EXTRACT_IFFT", "extract_ifft",
     ("auto", "native", "fourstep", "pallas", "fused")),
    ("RADIOCORE_TPU_STATION_RFFT", "station_rfft",
     ("auto", "pallas", "native")),
    ("RADIOCORE_TPU_ENV_FFT", "env_fft", ("native", "pallas")),
    ("RADIOCORE_TPU_FIR_IMPL", "fir_impl", ("pallas", "fft", "conv")),
])
def test_from_environ_reads_each_variable(clean_env, var, field, values):
    from radiocore_tpu_torch.runtime.routes import Routes
    for v in values:
        assert getattr(Routes.from_environ({var: v}), field) == v
        clean_env.setenv(var, v)
        r = Routes.from_environ()
        assert getattr(r, field) == v
        # Only that field moves.
        others = {f: getattr(r, f) for f in r.__dataclass_fields__
                  if f != field}
        assert others == {f: getattr(Routes(), f) for f in others}


@pytest.mark.parametrize("environ,match", [
    ({"RADIOCORE_TPU_EXTRACT_IFFT": "bogus"}, "RADIOCORE_TPU_EXTRACT_IFFT"),
    ({"RADIOCORE_TPU_STATION_RFFT": "kernel"}, "RADIOCORE_TPU_STATION_RFFT"),
    ({"RADIOCORE_TPU_ENV_FFT": "Pallas"}, "RADIOCORE_TPU_ENV_FFT"),
    ({"RADIOCORE_TPU_FIR_IMPL": "auto"}, "RADIOCORE_TPU_FIR_IMPL"),
    ({"RADIOCORE_TPU_FFT_PALLAS_MIN": "big"}, "RADIOCORE_TPU_FFT_PALLAS_MIN"),
    ({"RADIOCORE_TPU_FFT_MIXED_MIN": ""}, "RADIOCORE_TPU_FFT_MIXED_MIN"),
])
def test_unknown_variable_values_raise(environ, match):
    from radiocore_tpu_torch.runtime.routes import Routes
    with pytest.raises(ValueError, match=match):
        Routes.from_environ(environ)


@pytest.mark.parametrize("kw,match", [
    ({"extract_ifft": "kernel"}, "extract_ifft"),
    ({"extract_ifft": "Pallas"}, "extract_ifft"),
    ({"env_fft": "fused"}, "env_fft"),
    ({"fir_impl": "kernel"}, "fir_impl"),
    ({"station_rfft": "fourstep"}, "station_rfft"),
    ({"fft_kernel_min": -1}, "fft_kernel_min"),
    ({"fft_mixed_min": 2.5}, "fft_mixed_min"),
])
def test_unknown_field_values_raise(kw, match):
    from radiocore_tpu_torch.runtime.routes import Routes
    with pytest.raises(ValueError, match=match):
        Routes(**kw)


def test_entry_points_refuse_what_is_not_routes():
    from radiocore_tpu_torch.ops import fft as offt
    with pytest.raises(TypeError, match="Routes"):
        offt.fft(torch.zeros(8, dtype=torch.complex64),
                 {"fft_kernel_min": 0})


# ---- ops/fft ------------------------------------------------------------

def _r(**kw):
    from radiocore_tpu_torch.runtime.routes import Routes
    return Routes(**kw)


C64, C128, F32 = torch.complex64, torch.complex128, torch.float32
ROW_MIN, ROW_MAX = 256, 1 << 19


@pytest.mark.parametrize("n,dtype,is_cuda,kw,op,bins,slot", [
    # Defaults: only the band sizes reach a kernel.
    (1 << 18, C64, True, {}, "fft", None, "torch"),
    (1 << 24, C64, True, {}, "fft", None, "rows"),
    (96 << 18, C64, True, {}, "fft", None, "mixed"),
    (1 << 24, C64, True, {"fft_kernel_min": 0}, "fft", None, "torch"),
    (96 << 18, C64, True, {"fft_mixed_min": 0}, "fft", None, "torch"),
    # A lowered threshold: rows from MIN_ROW; never off the card or in
    # complex128.
    (1 << 18, C64, True, {"fft_kernel_min": 1 << 16}, "fft", None, "rows"),
    (ROW_MIN, C64, True, {"fft_kernel_min": 1}, "fft", None, "rows"),
    (ROW_MIN // 2, C64, True, {"fft_kernel_min": 1}, "fft", None, "torch"),
    (1 << 15, C64, True, {"fft_kernel_min": 1 << 16}, "fft", None, "torch"),
    (1 << 18, C64, False, {"fft_kernel_min": 1 << 16}, "fft", None,
     "torch"),
    (1 << 18, C128, True, {"fft_kernel_min": 1 << 16}, "fft", None,
     "torch"),
    (3 << 16, C64, True, {"fft_kernel_min": 1}, "fft", None, "torch"),
    (3 << 16, C64, True, {"fft_mixed_min": 1 << 16}, "fft", None, "mixed"),
    # rfft: float32 in, n/2 a row.
    (1 << 18, F32, True, {"fft_kernel_min": 1 << 16}, "rfft", None, "rows"),
    (2 * ROW_MIN, F32, True, {"fft_kernel_min": 1}, "rfft", None, "rows"),
    (ROW_MIN, F32, True, {"fft_kernel_min": 1}, "rfft", None, "torch"),
    (2 * ROW_MAX, F32, True, {"fft_kernel_min": 1}, "rfft", None, "rows"),
    (4 * ROW_MAX, F32, True, {"fft_kernel_min": 1}, "rfft", None, "torch"),
    (1 << 24, F32, True, {}, "rfft", None, "torch"),
    (1 << 18, C64, True, {"fft_kernel_min": 1 << 16}, "rfft", None,
     "torch"),
    (1 << 18, F32, False, {"fft_kernel_min": 1 << 16}, "rfft", None,
     "torch"),
    # irfft: only from exactly n//2 + 1 bins.
    (1 << 18, C64, True, {"fft_kernel_min": 1 << 16}, "irfft",
     (1 << 17) + 1, "rows"),
    (1 << 18, C64, True, {"fft_kernel_min": 1 << 16}, "irfft", 1 << 17,
     "torch"),
    (1 << 18, C64, True, {"fft_kernel_min": 1 << 16}, "irfft",
     (1 << 17) + 2, "torch"),
    (ROW_MIN, C64, True, {"fft_kernel_min": 1}, "irfft", ROW_MIN // 2 + 1,
     "torch"),
    (2 * ROW_MAX, C64, True, {"fft_kernel_min": 1}, "irfft",
     ROW_MAX + 1, "rows"),
    (4 * ROW_MAX, C64, True, {"fft_kernel_min": 1}, "irfft",
     2 * ROW_MAX + 1, "torch"),
    (1 << 18, C128, True, {"fft_kernel_min": 1 << 16}, "irfft",
     (1 << 17) + 1, "torch"),
    # Rows up to MAX_ROW, fft_large_pow2 beyond: both K-FFT.
    (ROW_MAX, C64, True, {"fft_kernel_min": 1}, "fft", None, "rows"),
    (2 * ROW_MAX, C64, True, {"fft_kernel_min": 1}, "fft", None, "rows"),
    (1 << 18, torch.float64, True, {"fft_kernel_min": 1 << 16}, "rfft",
     None, "torch"),
])
def test_route_name_table(n, dtype, is_cuda, kw, op, bins, slot):
    from radiocore_tpu_torch.kernels import fft_rows
    from radiocore_tpu_torch.ops import fft as offt
    assert (fft_rows.MIN_ROW, fft_rows.MAX_ROW) == (ROW_MIN, ROW_MAX)
    assert offt.route_name(n, dtype, is_cuda, _r(**kw), op=op,
                           bins=bins) == slot


@pytest.mark.parametrize("lg", [12, 13, 14, 15, 16])
def test_decomposed_match_jax(lg):
    from radiocore_tpu.ops import fft as jfft
    from radiocore_tpu_torch.ops import fft as offt
    x = _crandn(np.random.default_rng(lg), 3, 1 << lg)
    want = np.asarray(jfft.fft_decomposed(jnp.asarray(x)))
    got = offt.fft_decomposed(torch.from_numpy(x)).numpy()
    assert _rel_l2(got, want) < REL_L2
    want = np.asarray(jfft.ifft_decomposed(jnp.asarray(x)))
    got = offt.ifft_decomposed(torch.from_numpy(x)).numpy()
    assert _rel_l2(got, want) < REL_L2
    assert offt._split(1 << lg) == jfft._split(1 << lg)


@pytest.mark.parametrize("n", [3 << 14, 250_000, 65_537])
def test_decomposed_any_size_matches_jax(n):
    """``fft_decomposed``/``ifft_decomposed`` off a power of two (the
    reference's ``_split`` of a smooth size, of 250 000 and of a prime,
    which the library takes whole) against the JAX ones."""
    from radiocore_tpu.ops import fft as jfft
    from radiocore_tpu_torch.ops import fft as offt
    x = _crandn(np.random.default_rng(n), 2, n)
    for jf, tf in ((jfft.fft_decomposed, offt.fft_decomposed),
                   (jfft.ifft_decomposed, offt.ifft_decomposed)):
        want = np.asarray(jf(jnp.asarray(x)))
        assert _rel_l2(tf(torch.from_numpy(x)).numpy(), want) < REL_L2
    assert offt._split(n) == jfft._split(n)


# ---- ops/fir ------------------------------------------------------------

class _Cuda:
    """What ``fir_route`` reads of a tensor that would lie on a card."""
    is_cuda = True

    def __init__(self, dtype, n):
        self.dtype, self.shape = dtype, (4, n)


@pytest.mark.parametrize("fir_impl,dtype,n,slot", [
    ("pallas", F32, 65_536, "kernel"),
    ("pallas", F32, 16_383, "plain"),
    ("pallas", C64, 65_536, "plain"),
    ("fft", F32, 65_536, "fft"),
    ("fft", F32, 16_384, "fft"),
    ("fft", F32, 16_383, "plain"),
    ("fft", C64, 65_536, "fft"),
    ("conv", F32, 65_536, "plain"),
])
def test_fir_route_follows_fir_impl(fir_impl, dtype, n, slot):
    from radiocore_tpu_torch.ops import fir as tf
    r = _r(fir_impl=fir_impl)
    assert tf.fir_route(_Cuda(dtype, n), np.ones(51), "auto", r) == slot
    # An explicit impl is not the routes' to change.
    assert tf.fir_route(_Cuda(F32, n), np.ones(51), "plain", r) == "plain"


@pytest.mark.parametrize("fir_impl", ["fft", "conv", "pallas"])
def test_fir_causal_auto_matches_jax(clean_env, fir_impl):
    from radiocore_tpu.ops import fir as jf
    from radiocore_tpu_torch.ops import fir as tf
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40_000)).astype(np.float32)
    hist = rng.standard_normal((2, 50)).astype(np.float32)
    taps = np.hanning(51) / np.hanning(51).sum()
    clean_env.setenv("RADIOCORE_TPU_FIR_IMPL", fir_impl)
    want = np.asarray(jf.fir_causal(jnp.asarray(x), taps,
                                    history=jnp.asarray(hist)))
    got = tf.fir_causal(torch.from_numpy(x), taps,
                        history=torch.from_numpy(hist),
                        routes=_r(fir_impl=fir_impl)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---- ops/channelize -----------------------------------------------------

# The plan of tests/test_pipeline_pallas.py.
C, SC, AC = 4, 65_536, 16_384


def _offsets(c, sc):
    half = c * sc // 2 - sc // 2
    return [int(-half + i * sc) for i in range(c)]


@pytest.mark.parametrize("impl", ["auto", "native", "fourstep", "pallas",
                                  "fused"])
def test_make_extractor_routes_match_jax(clean_env, impl):
    """Each ``extract_ifft`` against the JAX extractor built under the
    same variable; and the lowering each takes on a CPU spectrum."""
    from radiocore_tpu.ops import channelize as jch
    from radiocore_tpu_torch.kernels import fft_rows
    from radiocore_tpu_torch.ops import channelize as tch
    from radiocore_tpu_torch.ops import fft as offt
    n = C * SC
    shifts = tuple(-o for o in _offsets(C, SC))
    spec = _crandn(np.random.default_rng(11), n)

    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    clean_env.setattr(tch, "extract_rows", spy("kernel", tch.extract_rows))
    clean_env.setattr(fft_rows, "fft_pow2", spy("rows", fft_rows.fft_pow2))
    clean_env.setattr(offt, "ifft_decomposed",
                      spy("fourstep", offt.ifft_decomposed))

    clean_env.setenv("RADIOCORE_TPU_EXTRACT_IFFT", impl)
    want = np.asarray(jch.make_extractor(n, shifts, SC)(jnp.asarray(spec)))
    ex = tch.make_extractor(n, shifts, SC, _r(extract_ifft=impl))
    got = ex(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape == (C, SC)
    assert np.all(_rel_l2(got, want, axis=-1) < REL_L2)
    assert calls == {"auto": [], "native": [], "fourstep": ["fourstep"],
                     "pallas": ["rows"], "fused": ["kernel"]}[impl]


def test_extractors_of_one_plan_differ_by_routes():
    from radiocore_tpu_torch.ops import channelize as tch
    from radiocore_tpu_torch.runtime.routes import Routes
    n, shifts = C * SC, tuple(-o for o in _offsets(C, SC))
    a = tch.make_extractor(n, shifts, SC, Routes(extract_ifft="native"))
    b = tch.make_extractor(n, shifts, SC, Routes(extract_ifft="pallas"))
    assert a is not b
    assert a is tch.make_extractor(n, list(shifts), SC,
                                   Routes(extract_ifft="native"))
    assert (tch.make_extractor(n, shifts, SC)
            is tch.make_extractor(n, shifts, SC, Routes()))


# ---- the multi-station step ---------------------------------------------

def _fm_band(rng, c, sc):
    """A band chunk of FM stereo stations plus noise (the band of
    tests/test_torch_pipeline.py: pure noise makes the demod
    ill-conditioned)."""
    from oracles import make_fm_iq, make_stereo_multiplex
    n = c * sc
    spec = np.zeros(n, np.complex128)
    k = (np.fft.fftfreq(sc) * sc).astype(np.int64)
    for i, off in enumerate(_offsets(c, sc)):
        mpx = make_stereo_multiplex(sc, sc, 300.0 + 200 * i, 1100.0 + 300 * i)
        spec[(off + k) % n] += np.fft.fft(make_fm_iq(mpx, 0.25)) * (n / sc)
    band = np.fft.ifft(spec)
    band += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return band.astype(np.complex64)


def _steps_match(monkeypatch, var, value, routes, c, sc, ac, mode="fast",
                 chunks=2, seed=21):
    from radiocore_tpu.parallel.pipeline import (
        make_multi_station_step as jax_step)
    from radiocore_tpu_torch.parallel.pipeline import (
        make_multi_station_step as torch_step)
    from radiocore_tpu_torch.runtime.checkpoint import state_from_numpy
    if var is not None:
        monkeypatch.setenv(var, value)
    n, offs = c * sc, _offsets(c, sc)
    step_j, state_j = jax_step(n, offs, sc, ac, mode=mode)
    step_t, _ = torch_step(n, offs, sc, ac, mode=mode, device="cpu",
                           routes=routes)
    rng = np.random.default_rng(seed)
    hist = {k: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
            for k, v in state_j.items()}
    state_j = {k: jnp.asarray(v) for k, v in hist.items()}
    state_t = state_from_numpy(hist, "cpu")
    for _ in range(chunks):
        band = _fm_band(rng, c, sc)
        want, state_j = step_j(jnp.asarray(band), state_j)
        got, state_t = step_t(torch.from_numpy(band), state_t)
        assert tuple(got.shape) == (c, ac, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    return step_t


@pytest.mark.parametrize("var,value,field", [
    ("RADIOCORE_TPU_EXTRACT_IFFT", "native", "extract_ifft"),
    ("RADIOCORE_TPU_EXTRACT_IFFT", "fourstep", "extract_ifft"),
    ("RADIOCORE_TPU_EXTRACT_IFFT", "pallas", "extract_ifft"),
    ("RADIOCORE_TPU_EXTRACT_IFFT", "fused", "extract_ifft"),
    ("RADIOCORE_TPU_STATION_RFFT", "pallas", "station_rfft"),
    ("RADIOCORE_TPU_STATION_RFFT", "native", "station_rfft"),
    ("RADIOCORE_TPU_FIR_IMPL", "fft", "fir_impl"),
    ("RADIOCORE_TPU_FIR_IMPL", "conv", "fir_impl"),
])
def test_fast_step_route_matches_jax(clean_env, var, value, field):
    """The ``fast`` step at 4 × 65 536 under one route against the JAX
    step under its variable, over two chained chunks."""
    _steps_match(clean_env, var, value, _r(**{field: value}), C, SC, AC)


def test_fast_step_env_fft_matches_jax(clean_env):
    """``env_fft="pallas"`` at 2 × 262 144, a plan whose tail works at the
    envelope rate (n2 = 65 536: K-FFT rows), against the JAX step under
    ``RADIOCORE_TPU_ENV_FFT=pallas`` (its kernel in interpret mode); the
    port's envelope transforms go through ``fft_rows``."""
    from radiocore_tpu_torch.kernels import fft_rows
    calls = []
    for name in ("fft_pow2", "rfft_pow2"):
        fn = getattr(fft_rows, name)
        clean_env.setattr(fft_rows, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    _steps_match(clean_env, "RADIOCORE_TPU_ENV_FFT", "pallas",
                 _r(env_fft="pallas"), 2, 262_144, 49_152, chunks=1)
    # Per chunk: the envelopes' backward row FFT and the L−R rfft; the
    # station rfft (auto) is torch on the CPU.
    assert calls == ["fft_pow2", "rfft_pow2"]


def test_exact_step_with_a_lowered_kernel_min_matches_jax(clean_env):
    """``mode="exact"`` with ``fft_kernel_min = 2^12``. The JAX package
    reads ``RADIOCORE_TPU_FFT_PALLAS_MIN`` only on a TPU (``has_tpu()`` in
    ``_use_pallas``), so the comparison is against its default; on a CPU
    tensor no K-FFT route is taken either, and the audio must agree."""
    from radiocore_tpu_torch.ops import fft as offt
    r = _r(fft_kernel_min=1 << 12)
    _steps_match(clean_env, None, None, r, 2, SC, AC, mode="exact")
    # On the card the same routes send the tail's 2^16 transforms to
    # K-FFT.
    assert offt.route_name(SC, F32, True, r, op="rfft") == "rows"
    assert offt.route_name(SC, C64, True, r) == "rows"
    assert offt.route_name(SC, C64, True, r, op="irfft",
                           bins=SC // 2 + 1) == "rows"


# ---- the apps ------------------------------------------------------------

def test_apps_read_the_environment_once(clean_env, tmp_path):
    """``receive_fm.main`` hands ``Routes.from_environ()`` to ``run``; an
    unknown value stops either app before it builds anything."""
    from radiocore_tpu_torch.apps import multi_fm_server as srv
    from radiocore_tpu_torch.apps import receive_fm as rx
    from radiocore_tpu_torch.runtime.routes import Routes
    seen = {}
    clean_env.setattr(rx, "run", lambda *a, **k: seen.update(k))
    clean_env.setenv("RADIOCORE_TPU_FIR_IMPL", "conv")
    clean_env.setenv("RADIOCORE_TPU_FFT_PALLAS_MIN", "6.5e4")
    rx.main(["--device", "cpu", "--seconds", "1", "--out",
             str(tmp_path / "fm.wav")])
    assert seen["routes"] == Routes(fir_impl="conv", fft_kernel_min=65_000)
    clean_env.setenv("RADIOCORE_TPU_ENV_FFT", "kernel")
    with pytest.raises(ValueError, match="RADIOCORE_TPU_ENV_FFT"):
        rx.main(["--device", "cpu", "--seconds", "1"])
    with pytest.raises(ValueError, match="RADIOCORE_TPU_ENV_FFT"):
        srv.main(["--device", "cpu", "--no-zmq", "--seconds", "1"])

"""The port's parallel layer against the JAX package on the CPU: the mesh,
the distributed FFTs, the distributed front end, the multi-station step
over a mesh (both branches, both modes) and a multi-process check as in
``test_multihost.py``.

The port runs in one 4-rank ``gloo`` world for the whole module
(``torch_parallel_worker.parallel_rank``); the JAX package runs here, on
4 of the 8 virtual CPU devices of ``conftest.py``, on the same seeded
inputs. Tolerances are those of the JAX tests: 2e-3 of the max on the
distributed FFTs (the port is also held to rel L2 1e-5 of complex128),
3e-4 of the max on extraction, 1e-4 abs on audio.
"""

import json

import numpy as np
import pytest
import torch
from scipy import signal as sig

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_parallel_worker as worker
from oracles import make_fm_iq, make_stereo_multiplex

torch.set_num_threads(2)

SC, AC = 50_000, 10_000
OFFS = {"dist": [-75_000, -25_000, 25_000, 75_000],     # uniform, critical
        "gather": [-75_000, -20_000, 25_000, 75_000]}   # not uniform
FFT_ATOL = 2e-3            # of max |X|, tests/test_fft_sharded.py
EXTRACT_ATOL = 3e-4        # of max |X|, tests/test_parallel.py:171
AUDIO_ATOL = 1e-4


def _fm_band(rng, offsets, sc):
    """A band of ``len(offsets)·sc`` samples with one FM stereo station
    at each offset (bins) plus a little noise."""
    n = len(offsets) * sc
    spec = np.zeros(n, np.complex128)
    k = (np.fft.fftfreq(sc) * sc).astype(np.int64)
    for i, off in enumerate(offsets):
        mpx = make_stereo_multiplex(sc, sc, 300.0 + 200 * i, 1100.0 + 300 * i)
        spec[(off + k) % n] += np.fft.fft(make_fm_iq(mpx, 0.25)) * (n / sc)
    band = np.fft.ifft(spec)
    band += 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return band.astype(np.complex64)


def _cn(rng, n, scale=1.0):
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def _grid_shifts(n, m):
    chunk = n // m
    return np.array([-(((k * chunk + n // 2) % n) - n // 2)
                     for k in range(m)])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from radiocore_tpu_torch.parallel.dryrun import run_world
    d = tmp_path_factory.mktemp("parallel_world")
    rng = np.random.default_rng(9)
    inputs = {f"fft{n}": _cn(rng, n) for n in (65_536, 200_000, 320_000)}
    inputs["tw"] = _cn(rng, 1 << 20)
    inputs["ex_band"] = _cn(rng, 200_000, 0.05)
    inputs["ex_shifts"] = -np.asarray(OFFS["dist"])
    inputs["c4_band"] = _cn(rng, 1 << 16, 0.1)
    inputs["c4_shifts"] = _grid_shifts(1 << 16, 16)
    inputs["fir33"] = sig.firwin(33, 0.45)
    inputs["fir129"] = sig.firwin(129, 0.4)
    inputs["fir33_025"] = sig.firwin(33, 0.25)
    for plan, offs in OFFS.items():
        inputs[f"offs_{plan}"] = np.asarray(offs)
        for k in range(2):
            inputs[f"band_{plan}{k}"] = _fm_band(rng, offs, SC)
    np.savez(d / "inputs.npz", **inputs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")   # each rank's threads
        run_world(worker.parallel_rank, worker.N_RANKS, str(d))
    arrays = dict(np.load(d / "rank0.npz"))
    infos = [json.loads((d / f"rank{r}.json").read_text())
             for r in range(worker.N_RANKS)]
    return inputs, arrays, infos


def _jax_mesh(stations, time):
    from radiocore_tpu.parallel.mesh import make_radio_mesh
    return make_radio_mesh(stations, time,
                           devices=jax.devices()[:stations * time])


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_mesh_construction_matches_jax(world):
    _, _, infos = world
    want = [dict(_jax_mesh(2, 2).shape), dict(_jax_mesh(4, 1).shape),
            dict(_jax_mesh(1, 4).shape)]
    for info in infos:
        assert info["mesh_shapes"] == want
        assert "!=" in info["mesh_(3, 2)"]
        assert "not divisible" in info["mesh_(0, 3)"]
    # Row-major ranks over (stations, time), as the JAX device reshape.
    grid = np.asarray(_jax_mesh(2, 2).devices)
    ids = np.vectorize(lambda dev: dev.id)(grid)
    for r, info in enumerate(infos):
        s, t = map(int, np.argwhere(ids == r)[0])
        assert info["axes"]["stations"] == ids[:, t].tolist()
        assert info["axes"]["time"] == ids[s, :].tolist()
        assert info["axes"][str(("stations", "time"))] == [0, 1, 2, 3]


def test_platform_summary_in_world(world):
    _, _, infos = world
    for r, info in enumerate(infos):
        assert info["summary"] == {"process_index": r,
                                   "process_count": worker.N_RANKS}


def _check_fft(got, x, jax_got):
    want = np.fft.fft(x.astype(np.complex128))
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, atol=FFT_ATOL * scale)
    np.testing.assert_allclose(got, np.asarray(jax_got),
                               atol=FFT_ATOL * scale)
    assert _rel_l2(got, want) < 1e-5


def test_fft_sharded_auto_matches_jax(world):
    from radiocore_tpu.parallel.fft_sharded import fft_sharded_auto
    inputs, arrays, _ = world
    x = inputs["fft65536"]
    _check_fft(arrays["auto"], x, fft_sharded_auto(x, _jax_mesh(1, 4)))


@pytest.mark.parametrize("n,n1", [(65_536, 256), (320_000, 400)])
def test_fft_sharded_fourstep_matches_jax(world, n, n1):
    from radiocore_tpu.parallel.fft_sharded import fft_sharded_fourstep
    inputs, arrays, _ = world
    x = inputs[f"fft{n}"]
    want = np.asarray(fft_sharded_fourstep(x, _jax_mesh(1, 4), n1=n1))
    _check_fft(arrays[f"fourstep{n}"].T.reshape(-1), x, want.T.reshape(-1))


@pytest.mark.parametrize("n", [65_536, 200_000])
def test_fft_sharded_blocks_matches_jax(world, n):
    from radiocore_tpu.parallel.fft_sharded import fft_sharded_blocks
    inputs, arrays, _ = world
    x = inputs[f"fft{n}"]
    _check_fft(arrays[f"blocks{n}"], x, fft_sharded_blocks(x, _jax_mesh(1, 4)))


def test_split_for_shards_matches_jax():
    from radiocore_tpu.parallel.fft_sharded import split_for_shards as jax_s
    from radiocore_tpu_torch.parallel.fft_sharded import split_for_shards
    assert split_for_shards(1 << 24, 8) == (8 * 512, 8 * 512)
    assert split_for_shards(1 << 24, 2) == (4096, 4096)
    for n, d in ((1 << 24, 2), (200_000, 4), (200_000, 8), (100, 8),
                 (320_000, 4), (400_000, 4), (7, 1), (12, 0)):
        assert split_for_shards(n, d) == jax_s(n, d)


def test_fourstep_local_at_2_20_over_two_ranks(world):
    """``_fourstep_local`` on 2^20 points with D = 2 against float64."""
    inputs, arrays, _ = world
    want = np.fft.fft(inputs["tw"].astype(np.complex128))
    got = arrays["fourstep_local"].T.reshape(-1)
    assert _rel_l2(got, want) < 1e-5


def test_twiddle_is_rounded_once_from_float64():
    """The twiddle of the column pass is ``W_N^{j·k1}`` from an integer
    angle index, evaluated in float64 and rounded once: every element is
    within float32 rounding (< 1e-7) of the exact value. Formed in
    float32, as the reference's program computes it without x64, the
    same table is off by more than that."""
    from radiocore_tpu_torch.parallel.fft_sharded import _twiddle
    n1 = n2 = 1024
    n = n1 * n2
    for me in (0, 1):
        j = np.arange(me * n2 // 2, (me + 1) * n2 // 2)[:, None]
        k1 = np.arange(n1)[None, :]
        exact = np.exp(-2j * np.pi * ((j * k1) % n) / n)
        got = _twiddle(n1, n2, 2, me, torch.device("cpu")).numpy()
        assert got.dtype == np.complex64
        assert np.abs(got - exact).max() < 1e-7
        ang32 = (np.float32(-2 * np.pi / n)
                 * (j.astype(np.float32) * k1.astype(np.float32)))
        f32 = np.exp(1j * ang32.astype(np.float32)).astype(np.complex64)
        assert np.abs(f32 - exact).max() > 1e-7


def test_extract_body_matches_jax_extractor(world):
    from radiocore_tpu.ops import fft as jfft
    from radiocore_tpu.ops.channelize import make_extractor
    inputs, arrays, _ = world
    extract = make_extractor(200_000, tuple(int(s) for s in
                                            inputs["ex_shifts"]), SC)
    want = np.asarray(extract(jfft.fft(jnp.asarray(inputs["ex_band"]))))
    got = arrays["extract"]
    assert got.shape == want.shape == (4, SC)
    np.testing.assert_allclose(got, want,
                               atol=EXTRACT_ATOL * np.max(np.abs(want)))


def test_extract_body_declines_as_jax():
    """The plan of ``test_parallel.py:158-176`` on 8 ranks: the uniform
    plan qualifies, the non-uniform one returns None, in both packages."""
    from radiocore_tpu.parallel.channelize_sharded import (
        make_extract_body as jax_body)
    from radiocore_tpu_torch.parallel.channelize_sharded import (
        make_extract_body)
    from radiocore_tpu_torch.parallel.collectives import (Axis,
                                                          CollectiveBytes)
    axis = Axis("time", tuple(range(8)), 0, None, None, CollectiveBytes())
    good = [-175_000, -125_000, -75_000, -25_000,
            25_000, 75_000, 125_000, 175_000]
    bad = [-175_000, -120_000, -75_000, -25_000,
           25_000, 75_000, 125_000, 175_000]
    for offs, takes in ((good, True), (bad, False)):
        shifts = tuple(-o for o in offs)
        assert (make_extract_body(400_000, shifts, SC, 8, axis)
                is not None) == takes
        assert (jax_body(400_000, shifts, SC, 8, "time")
                is not None) == takes
    # C % D != 0 and d == 1 decline too.
    assert make_extract_body(400_000, tuple(-o for o in good), SC, 3,
                             axis) is None
    assert make_extract_body(400_000, tuple(-o for o in good), SC, 1,
                             axis) is None


def test_config4_form_matches_unsharded_chain(world):
    """Halo overlap-save FIR, then the distributed front end, on one axis
    of 4 ranks (``test_parallel.py:179-216``), against JAX's unsharded
    FIR + FFT + extractor chain."""
    from radiocore_tpu.ops import fft as jfft
    from radiocore_tpu.ops.channelize import make_extractor
    from radiocore_tpu.ops.fir import fir_overlap_save
    inputs, arrays, _ = world
    n, m = 1 << 16, 16
    extract = make_extractor(n, tuple(int(s) for s in inputs["c4_shifts"]),
                             n // m)
    want = np.asarray(extract(jfft.fft(fir_overlap_save(
        jnp.asarray(inputs["c4_band"]), inputs["fir33"], block=4096))))
    np.testing.assert_allclose(arrays["config4"], want,
                               atol=EXTRACT_ATOL * np.max(np.abs(want)))


def test_collective_bytes_match_jax(world):
    """The port's byte counter against ``collective_bytes`` of the JAX
    programs compiled for 4 devices: the same collective-permute and
    all-reduce bytes. For all-to-all the port counts each call's result
    (3 × one block); the reference's regex counts the first element of
    each all-to-all's tuple result once more (its op line, besides the
    four ``get-tuple-element`` lines that name the op), 3 × a quarter
    block on top."""
    from radiocore_tpu.parallel.channelize_sharded import make_extract_body
    from radiocore_tpu.parallel.comm_analysis import collective_bytes
    from radiocore_tpu.parallel.halo import fir_overlap_save_halo
    inputs, _, infos = world
    n, m, d = 1 << 16, 16, 4
    mesh = _jax_mesh(1, d)
    spec = jax.ShapeDtypeStruct((n,), jnp.complex64)
    body = make_extract_body(n, tuple(int(s) for s in inputs["c4_shifts"]),
                             n // m, d, "time")
    ex = collective_bytes(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=P("time"), out_specs=P("time", None))
    ).lower(spec).compile().as_text())
    fir = collective_bytes(jax.jit(jax.shard_map(
        lambda b: fir_overlap_save_halo(b, inputs["fir129"], "time"),
        mesh=mesh, in_specs=P("time"), out_specs=(P("time"), P()))
    ).lower(spec).compile().as_text())
    block = n // d * 8
    for info in infos:
        got_ex, got_fir = info["bytes_extract"], info["bytes_fir129"]
        assert got_ex["collective-permute"] == ex["collective-permute"] \
            == block + 8 == 131_080
        assert got_fir["collective-permute"] == fir["collective-permute"] \
            == 1024
        assert got_fir["all-reduce"] == fir["all-reduce"] == 1024
        assert got_ex["all-to-all"] == 3 * block == 393_216
        assert ex["all-to-all"] == got_ex["all-to-all"] + 3 * block // d \
            == 491_520
        assert set(got_ex) == {"all-to-all", "collective-permute", "total"}
        assert got_fir["total"] == 2048


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("plan", ["dist", "gather"])
def test_mesh_step_matches_jax(world, plan, mode):
    """``make_multi_station_step(mesh=)`` on a 2 × 2 mesh, two chained
    chunks of an FM band, gathered over the ranks, against the JAX step
    on one device; the uniform plan takes the distributed front end, the
    other the all-gather branch."""
    from radiocore_tpu.parallel.pipeline import (
        make_multi_station_step as jax_step)
    inputs, arrays, infos = world
    offs = OFFS[plan]
    step, state = jax_step(4 * SC, offs, SC, AC, mode=mode)
    got = arrays[f"step_{plan}_{mode}"]
    assert got.shape == (2, 4, AC, 2)
    for k in range(2):
        want, state = step(jnp.asarray(inputs[f"band_{plan}{k}"]), state)
        np.testing.assert_allclose(got[k], np.asarray(want), atol=AUDIO_ATOL)
    for info in infos:
        assert info[f"distributed_{plan}_{mode}"] == (plan == "dist")


def test_processes_agree_and_match_single_process(world):
    """As ``test_multihost.py``: every rank holds the same gathered audio
    (its mean |.|), equal to the single-process JAX step's; the halo
    zero-phase FIR across the rank boundary equals the zero-padded
    forward-backward filter."""
    inputs, arrays, infos = world
    sums = [info["checksum"] for info in infos]
    assert all(s == sums[0] for s in sums)
    assert sums[0] == pytest.approx(
        float(np.abs(arrays["step_dist_exact"][-1]).mean()), rel=1e-6)
    taps = inputs["fir33_025"]
    x = np.sin(np.arange(2 * 4096, dtype=np.float64) * 0.01)
    fwd = np.correlate(np.concatenate([np.zeros(len(taps) - 1), x]),
                       taps[::-1], mode="valid")
    bwd = np.correlate(np.concatenate([fwd, np.zeros(len(taps) - 1)]),
                       taps, mode="valid")
    for info in infos:
        assert info["halo_checksum"] == pytest.approx(
            float(np.mean(np.abs(bwd))), rel=1e-4)


def test_projected_efficiency_has_no_default_rate():
    from radiocore_tpu.parallel.comm_analysis import (
        projected_efficiency as jax_eff)
    from radiocore_tpu_torch.parallel.comm_analysis import (
        collective_bytes, projected_efficiency)
    from radiocore_tpu_torch.parallel.collectives import CollectiveBytes
    assert projected_efficiency(0.01, 491_520, 100e9) == pytest.approx(
        jax_eff(0.01, 491_520, 100e9), rel=1e-12)
    with pytest.raises(TypeError):
        projected_efficiency(0.01, 491_520)
    counter = CollectiveBytes()
    counter.add("all-to-all", 10, 0.5)
    counter.add("all-to-all", 6, 0.25)
    counter.add("all-reduce", 0, 0.0)
    assert collective_bytes(counter) == {"all-to-all": 16, "total": 16}
    assert counter.seconds["all-to-all"] == 0.75
    counter.reset()
    assert collective_bytes(counter) == {"total": 0}

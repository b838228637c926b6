"""The port's halo exchange and time-sharded filters against the JAX
package on the CPU: the cells of ``test_halo_streaming.py`` (overlap-save
FIR and PFB over two chained chunks, with the carried state) and of
``test_parallel.py`` (causal and zero-phase halo FIRs), and the port's
multi-rank dry run.

The port runs in one 4-rank ``gloo`` world for the whole module
(``torch_parallel_worker.halo_rank``, a 4-rank ``time`` axis); the JAX
package runs here on the same seeded inputs, sharded over 4 of the 8
virtual CPU devices where the reference is a sharded function.
Tolerances are the JAX tests': 2e-5 on the streaming FIR, 2e-6 on the
PFB, 1e-7 on the carried history, 1e-5 on the causal FIR, 1e-4 on the
zero-phase interior against ``filtfilt``.
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

torch.set_num_threads(2)

D = worker.N_RANKS


def _iq(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from radiocore_tpu.ops.pfb import pfb_taps
    from radiocore_tpu_torch.parallel.dryrun import run_world
    d = tmp_path_factory.mktemp("halo_world")
    rng = np.random.default_rng(11)
    inputs = {
        "fir_x": rng.standard_normal(D * 512).astype(np.float32),
        "fir_taps": sig.firwin(33, 0.25),
        "zp_x": rng.standard_normal(D * 1024).astype(np.float32),
        "zp_taps": sig.firwin(41, 0.2),
        "ols_taps": sig.firwin(129, 0.4),
        "pfb_taps": pfb_taps(16, 8),
        "pfb_taps_p1": pfb_taps(16, 1),
    }
    for k in range(2):
        inputs[f"ols{k}"] = _iq(D * 8192, k)
        inputs[f"pfb{k}"] = _iq(D * 4096, 3 + k)
    np.savez(d / "inputs.npz", **inputs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")   # each rank's threads
        run_world(worker.halo_rank, D, str(d))
    arrays = dict(np.load(d / "rank0.npz"))
    infos = [json.loads((d / f"rank{r}.json").read_text()) for r in range(D)]
    return inputs, arrays, infos


def _jax_mesh():
    from radiocore_tpu.parallel.mesh import make_radio_mesh
    return make_radio_mesh(stations=1, time=D, devices=jax.devices()[:D])


def test_halo_exchange_pads_with_neighbours(world):
    """Each rank's block of a (2, 16) signal with 3 samples of its left
    neighbour and 2 of its right, zeros at the global edges."""
    _, arrays, _ = world
    x = np.arange(32, dtype=np.float32).reshape(2, 16)
    padded = np.pad(x, ((0, 0), (3, 2)))
    want = np.stack([padded[:, 4 * r:4 * r + 9] for r in range(D)])
    np.testing.assert_array_equal(arrays["halo"], want)


def test_fir_causal_sharded_matches_jax(world):
    from radiocore_tpu.ops.fir import fir_causal
    from radiocore_tpu.parallel.halo import fir_causal_sharded
    inputs, arrays, _ = world
    x, taps = inputs["fir_x"], inputs["fir_taps"]
    want = np.asarray(fir_causal(jnp.asarray(x), taps))
    np.testing.assert_allclose(arrays["fir_causal"], want, atol=1e-5)
    jax_sh = np.asarray(fir_causal_sharded(jnp.asarray(x), taps, _jax_mesh()))
    np.testing.assert_allclose(arrays["fir_causal"], jax_sh, atol=1e-5)


def test_zero_phase_fir_sharded_matches_jax(world):
    """Interior against ``filtfilt``; everywhere, the zero-padded global
    edges included, against the JAX sharded filter."""
    from radiocore_tpu.parallel.halo import zero_phase_fir_sharded
    inputs, arrays, _ = world
    x, taps = inputs["zp_x"], inputs["zp_taps"]
    got = arrays["zero_phase"]
    want = sig.filtfilt(taps, [1.0], x.astype(np.float64))
    edge = 3 * len(taps)
    np.testing.assert_allclose(got[edge:-edge], want[edge:-edge], atol=1e-4)
    jax_sh = np.asarray(zero_phase_fir_sharded(jnp.asarray(x), taps,
                                               _jax_mesh()))
    np.testing.assert_allclose(got, jax_sh, atol=1e-5)


def test_fir_overlap_save_halo_streams_as_jax(world):
    """Two chained chunks against the JAX unsharded streaming FIR and its
    sharded form; the carried state is the chunk's tail."""
    from radiocore_tpu.ops.fir import fir_overlap_save, fir_stream
    from radiocore_tpu.parallel.halo import fir_overlap_save_halo
    inputs, arrays, _ = world
    taps = inputs["ols_taps"]
    fn = jax.jit(jax.shard_map(
        lambda x, h: fir_overlap_save_halo(x, taps, "time",
                                           stream_history=h),
        mesh=_jax_mesh(), in_specs=(P("time"), P()),
        out_specs=(P("time"), P())))
    ref_hist = jnp.zeros(128, jnp.complex64)
    hist = jnp.zeros(128, jnp.complex64)
    for k in range(2):
        chunk = jnp.asarray(inputs[f"ols{k}"])
        ref = fir_overlap_save(chunk, taps, history=ref_hist)
        _, ref_hist = fir_stream(chunk, taps.astype(np.float32), ref_hist)
        y_sh, hist = fn(chunk, hist)
        np.testing.assert_allclose(arrays[f"ols_y{k}"], np.asarray(ref),
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(arrays[f"ols_y{k}"], np.asarray(y_sh),
                                   rtol=0, atol=2e-5)
    np.testing.assert_allclose(arrays["ols_hist"], inputs["ols1"][-128:],
                               atol=1e-7)
    np.testing.assert_allclose(arrays["ols_hist"], np.asarray(hist),
                               atol=1e-7)


def test_pfb_channelize_halo_streams_as_jax(world):
    from radiocore_tpu.ops.pfb import pfb_channelize, pfb_init
    inputs, arrays, _ = world
    m, p = 16, 8
    ref_hist = pfb_init(m, p)
    for k in range(2):
        ref, ref_hist = pfb_channelize(jnp.asarray(inputs[f"pfb{k}"]),
                                       inputs["pfb_taps"], m,
                                       history=ref_hist)
        got = arrays[f"pfb_ch{k}"]
        assert got.shape == (D * 4096 // m, m)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=2e-6)
    np.testing.assert_allclose(arrays["pfb_hist"],
                               inputs["pfb1"][-(p - 1) * m:], atol=1e-7)


def test_pfb_channelize_halo_one_tap_a_branch(world):
    """P = 1: no history to carry, so the sharded channelizer is the
    unsharded one frame for frame and its new history is empty."""
    from radiocore_tpu_torch.ops.pfb import pfb_channelize
    inputs, arrays, infos = world
    want, hist = pfb_channelize(torch.from_numpy(inputs["pfb0"]),
                                inputs["pfb_taps_p1"], 16)
    assert hist.shape == (0,)
    np.testing.assert_allclose(arrays["pfb_p1"], want.numpy(), rtol=0,
                               atol=1e-6)
    assert all(info["pfb_p1_hist_shape"] == [0] for info in infos)


def test_dryrun_multichip_on_two_cpu_ranks(monkeypatch):
    """The port's counterpart of ``__graft_entry__.dryrun_multichip``: one
    mesh step (2 stations a rank) and a halo zero-phase FIR over a time
    axis of 2, in a world it starts itself (two threads a rank)."""
    from radiocore_tpu_torch.parallel.dryrun import dryrun_multichip
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    dryrun_multichip(2, device_type="cpu")


def test_initialize_multihost_is_a_no_op_without_a_coordinator():
    import torch.distributed as dist
    from radiocore_tpu_torch.runtime.platform import (initialize_multihost,
                                                      platform_summary)
    initialize_multihost()
    initialize_multihost(num_processes=1, process_id=0)
    assert not dist.is_initialized()
    summary = platform_summary()
    assert (summary["process_index"], summary["process_count"]) == (0, 1)
    with pytest.raises(ValueError, match="num_processes"):
        initialize_multihost("localhost:1")

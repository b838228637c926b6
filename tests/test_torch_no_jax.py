"""The port never imports JAX, not even transitively, and its platform
probe answers without a card."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import radiocore_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        radiocore_tpu_torch.__path__, "radiocore_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"radiocore_tpu_torch.parallel.pipeline",
            "radiocore_tpu_torch.kernels.fft_mixed",
            "radiocore_tpu_torch.kernels.extract_demod",
            "radiocore_tpu_torch.kernels.nco_pll",
            "radiocore_tpu_torch.ops.nco_pll",
            "radiocore_tpu_torch.runtime.transfer",
            "radiocore_tpu_torch.models.fm",
            "radiocore_tpu_torch.models.mfm",
            "radiocore_tpu_torch.models.bandpass",
            "radiocore_tpu_torch.models.decimate",
            "radiocore_tpu_torch.models.deemphasis",
            "radiocore_tpu_torch.models.pll",
            "radiocore_tpu_torch.runtime.config",
            "radiocore_tpu_torch.runtime.metrics",
            "radiocore_tpu_torch.runtime.profiling",
            "radiocore_tpu_torch.runtime.ingest",
            "radiocore_tpu_torch.native",
            "radiocore_tpu_torch.native.build",
            "radiocore_tpu_torch.tools.buffer",
            "radiocore_tpu_torch.tools.ringbuffer",
            "radiocore_tpu_torch.tools.carrousel",
            "radiocore_tpu_torch.tools.chopper",
            "radiocore_tpu_torch.tools.tuner",
            "radiocore_tpu_torch.ops.synth",
            "radiocore_tpu_torch.apps",
            "radiocore_tpu_torch.apps.iq",
            "radiocore_tpu_torch.apps.receive_fm",
            "radiocore_tpu_torch.apps.multi_fm_server",
            "radiocore_tpu_torch.apps.multi_fm_receiver"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k in ('jax', 'radiocore_tpu')\n"
            "             or k.startswith(('jax.', 'jaxlib', 'radiocore_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_platform_summary_without_cuda():
    import torch
    from radiocore_tpu_torch.runtime import platform
    summary = platform.platform_summary()
    assert summary["has_cuda"] == torch.cuda.is_available()
    if not summary["has_cuda"]:
        assert summary["platform"] == "cpu"
        # No silent fallback to the CPU: the missing device is named.
        with pytest.raises(RuntimeError, match="CUDA device"):
            platform.default_device()


def test_cpu_tensors_never_reach_the_kernel_library(monkeypatch):
    """On CPU tensors every kernel wrapper and every pipeline mode runs
    its plain version: neither building nor loading the library is
    attempted."""
    import numpy as np
    import torch
    from radiocore_tpu_torch.kernels import (build, extract, extract_demod,
                                             fft_mixed, fft_rows, fir)
    from radiocore_tpu_torch.ops.fir import zero_phase_fir
    from radiocore_tpu_torch.ops.nco_pll import (nco_pll_track, pll_design,
                                                 pll_init)
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step

    def refuse(*_args, **_kwargs):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "library", refuse)
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    spec = torch.from_numpy((rng.standard_normal(1 << 16) + 1j
                             * rng.standard_normal(1 << 16)).astype(
                                 np.complex64))
    fft_rows.fft_pow2(spec[:4096])
    fft_rows.rfft_pow2(spec.real[:4096].contiguous())
    fft_mixed.fft_large_mixed(spec[:3 << 12])
    extract.extract_rows(spec, 0, 4, 1 << 14, 1.0 / (1 << 16))
    extract_demod.extract_demod_rows(spec, 0, 4, 1 << 14)
    extract_demod.extract_demod_spec_rows(spec, 0, 4, 1 << 14, keep_bins=99)
    fir.fir_causal_rows(spec.real[:1024].reshape(2, 512), np.ones(5))
    zero_phase_fir(spec.real[:40_000].reshape(2, 20_000), np.ones(41) / 41)
    nco_pll_track(spec.real[:1024].reshape(2, 512), pll_design(262_144),
                  pll_init((2,), device="cpu"))
    c, sc = 4, 65_536
    offs = [int(-(c * sc // 2 - sc // 2) + i * sc) for i in range(c)]
    band = torch.from_numpy((rng.standard_normal(c * sc) + 1j
                             * rng.standard_normal(c * sc)).astype(
                                 np.complex64))
    for mode, xd in (("fast", "off"), ("fast", "fused"), ("fast", "spec"),
                     ("exact", "off")):
        step, state = make_multi_station_step(c * sc, offs, sc, 16_384,
                                              mode=mode, extract_demod=xd,
                                              device="cpu")
        audio, _ = step(band, state)
        assert tuple(audio.shape) == (c, 16_384, 2)

"""The port never imports JAX, not even transitively, its platform
probe answers without a card, and only its routes module and its apps
read the routing variables."""

import ast
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
            "radiocore_tpu_torch.tools.nco_sweep",
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
            "radiocore_tpu_torch.apps.multi_fm_receiver",
            "radiocore_tpu_torch.ops.pfb",
            "radiocore_tpu_torch.parallel",
            "radiocore_tpu_torch.parallel.mesh",
            "radiocore_tpu_torch.parallel.collectives",
            "radiocore_tpu_torch.parallel.halo",
            "radiocore_tpu_torch.parallel.fft_sharded",
            "radiocore_tpu_torch.parallel.channelize_sharded",
            "radiocore_tpu_torch.parallel.comm_analysis",
            "radiocore_tpu_torch.parallel.dryrun",
            "radiocore_tpu_torch.runtime.platform",
            "radiocore_tpu_torch.runtime.routes",
            "radiocore_tpu_torch.runtime.graphs",
            "radiocore_tpu_torch.tools.acceptance"} <= set(mods)
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
    from radiocore_tpu_torch.ops.nco_pll import (nco_pll_subcarrier,
                                                 nco_pll_track, pll_design,
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
    nco_pll_subcarrier(spec.real[:1024].reshape(2, 512), pll_design(262_144),
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


def _environ_reads(tree):
    """``RADIOCORE_TPU_*`` names read from the environment in a module:
    ``os.environ.get(name)``, ``os.getenv(name)``, ``os.environ[name]``
    and ``name in os.environ``."""
    def is_environ(node):
        return (isinstance(node, ast.Attribute) and node.attr == "environ"
                or isinstance(node, ast.Name) and node.id == "environ")

    def name_of(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Call) and node.args:
            f = node.func
            if (isinstance(f, ast.Attribute)
                    and (f.attr in ("get", "pop", "setdefault")
                         and is_environ(f.value) or f.attr == "getenv")):
                names.append(name_of(node.args[0]))
        elif isinstance(node, ast.Subscript) and is_environ(node.value):
            names.append(name_of(node.slice))
        elif (isinstance(node, ast.Compare) and len(node.ops) == 1
              and isinstance(node.ops[0], (ast.In, ast.NotIn))
              and is_environ(node.comparators[0])):
            names.append(name_of(node.left))
        found += [n for n in names if n and n.startswith("RADIOCORE_TPU_")]
    return found


def test_only_routes_and_apps_read_routing_variables():
    pkg = Path(radiocore_tpu_torch.__path__[0])
    allowed = {pkg / "runtime" / "routes.py"}
    readers = {}
    for path in sorted(pkg.rglob("*.py")):
        found = _environ_reads(ast.parse(path.read_text()))
        if found:
            readers[str(path.relative_to(pkg))] = found
        if path in allowed or (pkg / "apps") in path.parents:
            continue
        assert not found, f"{path.relative_to(pkg)} reads {found}"
    # The check sees the reads that are allowed.
    assert readers == {"apps/multi_fm_server.py":
                       ["RADIOCORE_TPU_EXTRACT_DEMOD"]}, readers


def test_the_bands_step_and_its_benchmark_modules_without_jax(monkeypatch):
    """The multi-band step on CPU tensors never reaches the kernel
    library, and the benchmark's modules for it (its pools, reference,
    loop, bounds and readers) import neither JAX nor the JAX package."""
    import numpy as np
    import torch
    from radiocore_tpu_torch.kernels import build
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step

    def refuse(*_args, **_kwargs):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "library", refuse)
    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    band = torch.from_numpy((rng.standard_normal((2, 1 << 18)) + 1j
                             * rng.standard_normal((2, 1 << 18))).astype(
                                 np.complex64))
    for mode in ("fast", "exact"):
        step, state = make_multi_station_step(
            1 << 18, None, 1 << 16, 16_384, mode=mode,
            bands=[[-65_536, 0, 65_536], [-32_768]], device="cpu")
        audio, _ = step(band, state)
        assert tuple(audio.shape) == (4, 16_384, 2)
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "for m in ('portbench.bands', 'portbench.roofline_bands',\n"
            "          'portbench.references.multi_bands',\n"
            "          'portbench.loops.resident_bands'):\n"
            "    importlib.import_module(m)\n"
            "from portbench import harness\n"
            "for name in ('bands_fft_roofline', 'gather_roofline',\n"
            "             'front_end_ms.bands'):\n"
            "    harness.reader(name)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k in ('jax', 'radiocore_tpu')\n"
            "             or k.startswith(('jax.', 'jaxlib', 'radiocore_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

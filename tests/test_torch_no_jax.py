"""The port never imports JAX, not even transitively, and its platform
probe answers without a card."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import radiocore_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        radiocore_tpu_torch.__path__, "radiocore_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "radiocore_tpu_torch.parallel.pipeline" in mods
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
        assert platform.default_device() == torch.device("cpu")

"""The port's native host code where it cannot be built: a missing C++
source counts as "not built" (the NumPy and Python versions run), an
installed package builds under a per-user cache, and the packaging ships
the port's sources."""

import os
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from radiocore_tpu_torch.native import build

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "radiocore_tpu_torch"


@pytest.fixture
def fresh_loaders(monkeypatch):
    """The loaders' caches empty before and after the test, so that what
    it patches is seen and not kept."""
    build._load.cache_clear()
    build._load_iq.cache_clear()
    yield monkeypatch
    build._load.cache_clear()
    build._load_iq.cache_clear()


def test_missing_sources_run_the_plain_versions(fresh_loaders, tmp_path):
    from radiocore_tpu_torch.apps.iq import convert_iq
    from radiocore_tpu_torch.native import (iq_native_available,
                                            native_available)
    from radiocore_tpu_torch.tools.ringbuffer import RingBuffer
    fresh_loaders.setattr(build, "_SRC", tmp_path / "ringbuffer.cpp")
    fresh_loaders.setattr(build, "_IQ_SRC", tmp_path / "iqconvert.cpp")
    raw = np.arange(16, dtype=np.int16)
    got = convert_iq(raw, "cs16")
    want = (raw.astype(np.float32) * (1.0 / 32768.0)).view(np.complex64)
    np.testing.assert_array_equal(got, want)
    assert not native_available()
    assert not iq_native_available()
    assert build.iq_f32_to_s16_native(np.zeros(4, np.float32)) is None
    ring = RingBuffer(64, backend="auto")
    assert ring.backend == "python"
    with pytest.raises(RuntimeError, match="native ring unavailable"):
        RingBuffer(64, backend="native")
    assert not list(tmp_path.iterdir())


def test_unwritable_package_builds_under_the_user_cache(fresh_loaders,
                                                        tmp_path):
    real_access = os.access
    pkg = str(PKG)

    def access(path, mode, *args, **kwargs):
        if str(path) == pkg and mode & os.W_OK:
            return False
        return real_access(path, mode, *args, **kwargs)

    fresh_loaders.setattr(build.os, "access", access)
    fresh_loaders.setenv("HOME", str(tmp_path))
    cache = tmp_path / ".cache" / "radiocore_tpu_torch" / "native"
    assert build.build_dir() == cache
    raw = np.arange(-8, 8, dtype=np.int8)
    got = build.iq_convert_native(raw, "cs8")
    if got is None:   # no C++ compiler here: nothing was built
        assert not any(cache.rglob("*.so"))
    else:
        np.testing.assert_array_equal(got, raw.astype(np.float32) / 128.0)
        assert len(list(cache.rglob("libradiocore_iq.so"))) == 1


def test_a_checkout_builds_beside_the_package():
    assert build.build_dir() == PKG / "_build" / "native"


def test_pyproject_ships_the_ports_sources():
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    package_data = data["tool"]["setuptools"]["package-data"]
    assert package_data["radiocore_tpu.native"] == ["*.cpp"]
    shipped = set()
    for package, globs in (("radiocore_tpu_torch.native", ["*.cpp"]),
                           ("radiocore_tpu_torch",
                            ["csrc/*.cu", "csrc/*.cuh"])):
        assert set(globs) <= set(package_data[package]), package
        where = REPO.joinpath(*package.split("."))
        for pattern in package_data[package]:
            shipped |= set(where.glob(pattern))
    sources = set((PKG / "native").glob("*.cpp")) | {
        p for p in (PKG / "csrc").iterdir() if p.is_file()}
    assert sources and sources <= shipped, sources - shipped

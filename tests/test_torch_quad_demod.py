"""K-QDEMOD (``kernels/quad_demod``, ``csrc/quad_demod.cu``) on the CPU:
its plain version is the torch chain ``ops/demod`` ran before the kernel,
bit for bit; the wrapper's refusals come before any launch; the C entry's
parameters are the ctypes signature; the launch geometry and the 16-byte
path at the paths' shapes; a walk of the kernel's threads (samples a
thread, the predecessor from the lane before, lane 0's own load) gives
the plain quad; and the module imports without ``nvcc``, a card or JAX.
The kernel itself runs in ``tests/test_torch_quad_demod_card.py``."""

import itertools
import math
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from radiocore_tpu_torch.kernels import build
from radiocore_tpu_torch.kernels import quad_demod as kq
from radiocore_tpu_torch.ops.demod import quadrature_demod

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SOURCE = build.CSRC_DIR / "quad_demod.cu"
SMS = 132                   # an H100's SMs
BLOCKS_AN_SM = 2048 // kq.THREADS


def chain_before_the_kernel(iq, gain=None):
    """``ops/demod.quadrature_demod`` as it was before K-QDEMOD."""
    d = torch.addcmul(iq.new_zeros(()), iq[..., 1:],
                      torch.conj(iq[..., :-1]))
    ph = torch.angle(d) * (1.0 / math.pi if gain is None else gain)
    return F.pad(ph, (1, 0))


def _iq(shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) + 1j
                             * rng.standard_normal(shape)).astype(
                                 np.complex64))


@pytest.mark.parametrize("gain", [None, 0.5])
@pytest.mark.parametrize("shape", [(1,), (2,), (4096,), (3, 4097),
                                   (2, 1, 5003), (2, 3, 240)])
def test_plain_is_the_chain_before_the_kernel(shape, gain):
    iq = _iq(shape, seed=len(shape))
    want = chain_before_the_kernel(iq, gain)
    assert torch.equal(kq.quad_demod_plain(iq, gain), want)
    assert torch.equal(quadrature_demod(iq, gain), want)


def test_plain_on_a_row_slice_and_dead_rows():
    """A slice off the first sample (rows off a 16-byte boundary on the
    card) and rows of signed zeros, as the chain gave them."""
    iq = _iq((4, 1001), seed=7)[:, 1:]
    signs = list(itertools.product([0.0, -0.0], repeat=2))
    iq[1] = torch.tensor([complex(a, b) for a, b in signs] * 250)
    iq[2] = -0.0
    want = chain_before_the_kernel(iq)
    got = kq.quad_demod_plain(iq)
    assert torch.equal(got, want)
    assert bool((got[1:3] == 0).all())


@pytest.fixture
def no_launch(monkeypatch):
    """``build.library`` fails the test if the wrapper reaches it."""
    def library():
        raise AssertionError("the wrapper reached the kernel library")
    monkeypatch.setattr(build, "library", library)
    return kq.launches.count


@pytest.mark.parametrize("dtype", [torch.complex128, torch.float32])
def test_wrapper_refuses_another_dtype_before_any_launch(no_launch, dtype):
    with pytest.raises(TypeError, match="complex64"):
        kq.quad_demod_rows(torch.zeros((2, 16), dtype=dtype))
    assert kq.launches.count == no_launch


def test_wrapper_refuses_a_cpu_tensor_before_any_launch(no_launch):
    with pytest.raises(ValueError, match="CUDA"):
        kq.quad_demod_rows(_iq((2, 16)))
    assert kq.launches.count == no_launch


def test_demod_refuses_a_device_without_a_kernel(no_launch):
    with pytest.raises(ValueError, match="no kernel for meta"):
        quadrature_demod(torch.zeros((2, 16), dtype=torch.complex64,
                                     device="meta"))
    assert kq.launches.count == no_launch


def _entry():
    src = SOURCE.read_text()
    params = re.search(r'extern "C" int rc_quad_demod\(([^)]*)\)',
                       src).group(1)
    return [" ".join(p.split()) for p in params.split(",")]


def test_the_c_entry_is_the_ctypes_signature():
    decls = _entry()
    kinds = {"void*": build._P, "long long": build._L, "int": build._I,
             "float": build._F}
    types = [kinds[" ".join(d.replace("const ", "").split()[:-1])]
             for d in decls]
    names = [d.split()[-1].lstrip("*") for d in decls]
    assert types == build._SIGNATURES["rc_quad_demod"]
    assert names == ["x", "x_stride", "y", "rows", "n", "gain", "stream"]


def test_the_geometry_is_the_sources():
    src = SOURCE.read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (const["kThreads"], const["kSamples"]) == (kq.THREADS, kq.SAMPLES)
    assert "kTile = kThreads * kSamples" in src
    assert kq.TILE == kq.THREADS * kq.SAMPLES == 1024


# (what, rows, n, byte offset of the first row, row stride in points,
# 16-byte path, blocks)
GEOMETRY = [
    ("wbfm24 step, 24 x 240 000", 24, 240_000, 0, 240_000, True, 5640),
    ("a mix group, rows 8:16", 8, 240_000, 8 * 240_000 * 8, 240_000, True,
     1880),
    ("receive_fm, 250 000", 1, 250_000, 0, 250_000, True, 245),
    ("the power-of-two plan", 64, 262_144, 0, 262_144, True, 16_384),
    ("an odd length", 3, 250_001, 0, 250_001, False, 735),
    ("a row slice off a 16-byte boundary", 3, 240_000, 8, 240_001, False,
     705),
    ("one row off a 16-byte boundary", 1, 240_000, 8, 240_000, False, 235),
    ("odd row stride", 2, 240_000, 0, 240_001, False, 470),
    ("one sample", 1, 1, 0, 1, False, 1),
]


@pytest.mark.parametrize("what,rows,n,offset,stride,vec,nblocks", GEOMETRY,
                         ids=[g[0] for g in GEOMETRY])
def test_launch_geometry(what, rows, n, offset, stride, vec, nblocks):
    assert kq.vectorised(4096 + offset, stride, rows, n) is vec
    assert kq.blocks(rows, n) == nblocks


@pytest.mark.parametrize("rows", [8, 24])
def test_the_grid_fills_the_card(rows):
    """At the mix's 8 rows as at 24, more blocks than the 132 SMs hold at
    once, so that no SM idles while a row is left."""
    assert kq.blocks(rows, 240_000) > SMS * BLOCKS_AN_SM


def test_the_paths_row_views_take_the_16_byte_path():
    """A group's rows of the station IQ keep the 16-byte path; a slice off
    the first sample and an odd length leave it."""
    st_iq = torch.zeros((24, 240_000), dtype=torch.complex64)
    for a, b in ((0, 8), (8, 16), (16, 24)):
        v = st_iq[a:b]
        assert kq.vectorised(v.data_ptr(), v.stride(0), b - a, 240_000)
    off = torch.zeros((3, 240_001), dtype=torch.complex64)[:, 1:]
    assert not kq.vectorised(off.data_ptr(), off.stride(0), 3, 240_000)
    odd = torch.zeros((3, 250_001), dtype=torch.complex64)
    assert not kq.vectorised(odd.data_ptr(), odd.stride(0), 3, 250_001)


def kernel_walk(x: np.ndarray, gain: float) -> np.ndarray:
    """The kernel's threads in float64: block b takes row b // tiles and
    samples (b % tiles)·TILE + SAMPLES·thread on; a thread's first sample
    takes as predecessor the last sample of the lane before it, or, in
    lane 0, the sample it loads itself; lanes past the row's end hold
    zeros and store nothing."""
    rows, n = x.shape
    tiles = -(-n // kq.TILE)
    y = np.full((rows, n), np.nan)
    for b in range(kq.blocks(rows, n)):
        row, tile = divmod(b, tiles)
        t0 = tile * kq.TILE + kq.SAMPLES * np.arange(kq.THREADS)
        idx = t0[:, None] + np.arange(kq.SAMPLES)
        s = np.where(idx < n, x[row, np.minimum(idx, n - 1)], 0)
        lane0 = np.arange(kq.THREADS) % 32 == 0
        own = np.where((t0 > 0) & (t0 < n), x[row, np.clip(t0 - 1, 0, n - 1)],
                       0)
        shuffled = np.roll(s[:, -1], 1)     # from the lane before
        p = np.where(lane0, own, shuffled)
        prev = np.concatenate([p[:, None], s[:, :-1]], axis=1)
        d = 0 + s * np.conj(prev)
        q = np.angle(d) * gain
        q[:, 0] = np.where(t0 == 0, 0.0, q[:, 0])
        keep = idx < n
        y[row, idx[keep]] = q[keep]
    return y


@pytest.mark.parametrize("rows,n", [(1, 1), (2, 5), (3, 1024), (2, 2049),
                                    (2, 3001)])
def test_the_kernels_walk_gives_the_plain_quad(rows, n):
    x = _iq((rows, n), seed=n).numpy().astype(np.complex128)
    got = kernel_walk(x, 1 / np.pi)
    want = np.angle(x[:, 1:] * np.conj(x[:, :-1])) / np.pi
    assert not np.isnan(got).any()
    assert (got[:, 0] == 0).all()
    np.testing.assert_allclose(got[:, 1:], want, rtol=0, atol=1e-15)


def test_imports_without_nvcc_a_card_or_jax():
    mods = {m.name for m in pkgutil.walk_packages(
        __import__("radiocore_tpu_torch").__path__, "radiocore_tpu_torch.")}
    assert "radiocore_tpu_torch.kernels.quad_demod" in mods
    env = {k: v for k, v in os.environ.items() if k != "PATH"}
    env.update(PATH="/nonexistent", CUDA_VISIBLE_DEVICES="")
    code = ("import sys, shutil\n"
            "import radiocore_tpu_torch.kernels.quad_demod as kq\n"
            "import radiocore_tpu_torch.ops.demod\n"
            "assert shutil.which('nvcc') is None\n"
            "assert 'jax' not in sys.modules\n"
            "from radiocore_tpu_torch.kernels import build\n"
            "assert build._LIB is None and kq.launches.count == 0\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)

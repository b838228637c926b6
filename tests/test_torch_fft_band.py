"""K-BANDFFT (``kernels/fft_band``, ``csrc/fft_band.cu``) on the CPU: its
split and chains, the routes that reach it, the two passes modelled in
numpy (``fft_band.band_model``: the chains, the twiddle tables, the
scratch's order and the store of element k2 of row k1 at k1 + a·k2)
against np.fft in complex128 and against the JAX package's transform,
and the wrapper's refusals, all before any kernel."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radiocore_tpu_torch.kernels import build
from radiocore_tpu_torch.kernels import fft_band as fb

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "radiocore_tpu_torch" / "csrc" / "fft_band.cu"
C64, C128, F32 = torch.complex64, torch.complex128, torch.float32
N = 10_000_000
# Chains of small sizes for the model: the kernels' order at sizes the
# CPU tests take in a moment (n: column chain, row chain).
SMALL = {
    320: ((16,), (5, 4)),
    1000: ((5, 8), (25,)),
    2000: ((5, 16), (25,)),
    2160: ((3, 16), (5, 9)),
    3125: ((25, 5), (25,)),
    10_800: ((3, 5, 8), (9, 5, 2)),
    16_000: ((16, 8), (25, 5)),
    240_000: ((5, 3, 16, 2), (25, 5, 4)),
}


def _c64(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n, dtype=np.float32)
            + 1j * rng.standard_normal(n, dtype=np.float32)
            ).astype(np.complex64)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---- the split and the plans ------------------------------------------

def test_the_band_splits_into_3200_by_3125():
    assert fb.band_split(N) == (3200, 3125)
    assert fb.CHAINS[3200] == (25, 16, 8)
    assert fb.CHAINS[3125] == (25, 25, 5)


@pytest.mark.parametrize("n", [
    7 * 3200 * 3125,          # 7-smooth, not 5-smooth
    10_000_019,               # a prime
    1 << 24,                  # 4096 · 4096: a side above MAX_SIDE
    5 ** 11,                  # 3125 · 15625
    3203 * 3200,              # a factor that is not smooth
    5 ** 10,                  # 3125 · 3125: a not a multiple of 4
    6_400_000,                # 2560 · 2500: sides without a chain built in
    240_000, 16_000, 2160,    # station-rate and small sizes
])
def test_sizes_without_a_split(n):
    assert fb.band_split(n) is None


@pytest.mark.parametrize("n", [N, 3200 * 3200])
def test_a_split_has_plans_on_chip(n):
    a, b = fb.band_split(n)
    assert a * b == n and a == 3200
    for side in (a, b):
        assert side <= fb.MAX_SIDE
        plan = fb.CHAINS[side]
        assert int(np.prod(plan)) == side
        odd = [r for r in plan if r % 2]
        assert list(plan[:len(odd)]) == sorted(odd, reverse=True)
        # The first stage is one butterfly a thread, every chain's first
        # radix the one the C entry assumes.
        assert side // plan[0] <= fb.THREADS
        assert plan[0] == 25


def test_the_split_prefers_a_multiple_of_4_for_a():
    """3200 · 3125 and 3125 · 3200 are as balanced; the row pass stores
    whole 32-byte sectors only where a is a multiple of 4."""
    a, b = fb.band_split(10_000_000)
    assert a % 4 == 0 and b % 4 != 0


@pytest.mark.parametrize("L,plan", [
    (3200, (25, 16, 8)), (3125, (25, 25, 5)), (480, (5, 3, 16, 2)),
    (45, (5, 9)), (16, (16,))])
def test_digit_reversal_and_first_points(L, plan):
    rev = fb.digit_reversal(L, plan)
    assert sorted(rev.tolist()) == list(range(L))
    j0 = fb.first_points(L, plan)
    r0 = plan[0]
    assert len(j0) == L // r0
    # Butterfly bf of the first stage takes the points that a
    # digit-reversed load would put at bf*R0 + q: j0 + q*L/R0.
    for bf in sorted({0, len(j0) // 2, len(j0) - 1}):
        for q in range(r0):
            assert rev[j0[bf] + q * (L // r0)] == bf * r0 + q


def test_the_scratch_order_is_a_bijection():
    a, b = 3200, 3125
    idx = fb.scratch_index(np.arange(a)[:, None], np.arange(b)[None, :],
                           a, b)
    assert len(np.unique(idx)) == a * b
    assert 0 <= idx.min() and idx.max() < fb.scratch_points(a, b)
    # A row unit (4 rows) reads 16 neighbours of each tile of columns.
    unit = fb.scratch_index(np.arange(8, 12)[:, None],
                            np.arange(4)[None, :], a, b)
    assert sorted(unit.ravel().tolist()) == list(range(unit.min(),
                                                       unit.min() + 16))


def test_the_tables_round_float64_once():
    a, b = 3200, 3125
    n = a * b
    tab = fb.table_np(fb.CHAINS[a], fb.CHAINS[b])
    off = fb.table_offsets(a, b)
    assert tab.dtype == np.complex64
    assert off["row"] == a - 1 and off["u"] == a + b - 2
    assert len(tab) == off["v"] + (1 << fb.U_BITS) * a
    u = tab[off["u"]:off["v"]].reshape(-1, a).astype(np.complex128)
    v = tab[off["v"]:].reshape(1 << fb.U_BITS, a).astype(np.complex128)
    rng = np.random.default_rng(3)
    k1 = rng.integers(0, a, 4096)
    j2 = rng.integers(0, b, 4096)
    want = np.exp(-2j * np.pi * ((k1 * j2) % n) / n)
    got = u[j2 >> fb.U_BITS, k1] * v[j2 & ((1 << fb.U_BITS) - 1), k1]
    assert np.max(np.abs(got - want)) < 2e-7
    col = tab[:a - 1].astype(np.complex128)
    ns, at = 1, 0
    for r in fb.CHAINS[a]:
        q, bm = np.meshgrid(np.arange(1, r), np.arange(ns), indexing="ij")
        exact = np.exp(-2j * np.pi * q * bm / (ns * r)).ravel()
        assert np.max(np.abs(col[at:at + exact.size] - exact)) < 1e-7
        at += exact.size
        ns *= r


# ---- the two passes in numpy ------------------------------------------

@pytest.mark.parametrize("n", [320, 1000, 2160, 16_000, 10_800, 240_000])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_the_model_against_numpy(n, sign):
    x = _c64(n, seed=n).astype(np.complex128)
    got = fb.band_model(x, sign, chains=SMALL[n])
    want = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * n
    assert _rel_l2(got, want) < 1e-7


def test_the_model_of_a_batch():
    x = np.stack([_c64(2160, seed=s) for s in range(3)])
    got = fb.band_model(x, -1.0, chains=SMALL[2160])
    assert got.shape == x.shape
    assert _rel_l2(got, np.fft.fft(x.astype(np.complex128), axis=-1)) < 1e-7


@pytest.mark.parametrize("n", [N, 3200 * 3200])
def test_the_model_at_the_band(n):
    """The sizes routed to the kernels: 10^7 = 3200 · 3125, the chains
    (25, 16, 8) and (25, 25, 5), and 3200 · 3200."""
    x = _c64(n, seed=29)
    got = fb.band_model(x, -1.0, block=1 << 20)
    want = np.fft.fft(x.astype(np.complex128))
    assert _rel_l2(got, want) < 1e-7


# ---- routes -----------------------------------------------------------

def _r(**kw):
    from radiocore_tpu_torch.runtime.routes import Routes
    return Routes(**kw)


@pytest.mark.parametrize("n,dtype,is_cuda,kw,op,slot", [
    (10_000_000, C64, True, {}, "fft", "band"),
    (3200 * 3200, C64, True, {}, "fft", "band"),
    (5 ** 10, C64, True, {}, "fft", "torch"),
    (10_000_000, C64, True, {"fft_mixed_min": 0}, "fft", "torch"),
    (10_000_000, C128, True, {}, "fft", "torch"),
    (10_000_000, C64, False, {}, "fft", "torch"),
    (10_000_000, F32, True, {}, "rfft", "torch"),
    (240_000, C64, True, {}, "fft", "torch"),
    (120_000, C64, True, {}, "fft", "torch"),
    (65_536, C64, True, {}, "fft", "torch"),
    (48_000, C64, True, {}, "fft", "torch"),
    (96 << 18, C64, True, {}, "fft", "mixed"),
    (1 << 24, C64, True, {}, "fft", "rows"),
    (20_000_000, C64, True, {}, "fft", "torch"),
    (240_000, C64, True, {"fft_mixed_min": 1 << 16}, "fft", "torch"),
])
def test_route_name(n, dtype, is_cuda, kw, op, slot):
    from radiocore_tpu_torch.ops import fft as offt
    assert offt.route_name(n, dtype, is_cuda, _r(**kw), op=op) == slot


def test_no_new_route_field():
    import dataclasses
    from radiocore_tpu_torch.runtime.routes import Routes
    names = {f.name for f in dataclasses.fields(Routes)}
    assert "fft_mixed_min" in names
    assert not any("band" in name for name in names)


# ---- the kernels' order against the JAX package -----------------------

@pytest.mark.parametrize("n", [2000, 3125])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_fft_matches_the_jax_package(n, sign):
    """The model of the two passes against the JAX package's transform
    (its ifft normalized, the kernels' backward sign not)."""
    from radiocore_tpu.ops import fft as jfft
    x = _c64(n, seed=n) * 0.5
    if sign < 0:
        want = np.asarray(jfft.fft(jnp.asarray(x)))
    else:
        want = np.asarray(jfft.ifft(jnp.asarray(x))) * n
    got = fb.band_model(x, sign, chains=SMALL[n])
    assert _rel_l2(got, want) < 1e-6


def test_the_plain_version_is_torch_fft():
    x = torch.from_numpy(_c64(2160, seed=5)).reshape(1, -1)
    assert torch.equal(fb.fft_band(x, -1.0), torch.fft.fft(x))
    assert torch.equal(fb.fft_band(x, 1.0),
                       torch.fft.ifft(x, norm="forward"))


# ---- the wrapper's refusals -------------------------------------------

@pytest.fixture
def no_launch(monkeypatch):
    """``build.library`` fails the test if the wrapper reaches it."""
    def library():
        raise AssertionError("the wrapper reached the kernel library")
    monkeypatch.setattr(build, "library", library)
    return fb.launches.count


@pytest.mark.parametrize("dtype", [C128, F32])
def test_refuses_another_dtype(no_launch, dtype):
    with pytest.raises(TypeError, match="complex64"):
        fb.fft_band_rows(torch.zeros((1, 2160), dtype=dtype))
    assert fb.launches.count == no_launch


@pytest.mark.parametrize("shape", [(1, 2161), (2, 7 * 1024), (0, 2160), ()])
def test_refuses_a_length_without_a_split(no_launch, shape):
    with pytest.raises(ValueError, match="band split"):
        fb.fft_band_rows(torch.zeros(shape, dtype=C64))
    assert fb.launches.count == no_launch


def test_refuses_a_strided_tensor(no_launch):
    x = torch.zeros(1, dtype=C64).expand(1, N)
    with pytest.raises(ValueError, match="contiguous"):
        fb.fft_band_rows(x)
    assert fb.launches.count == no_launch


def test_refuses_a_lazy_conj(no_launch):
    x = torch.zeros((1, N), dtype=C64, device="meta").conj()
    with pytest.raises(ValueError, match="conj"):
        fb.fft_band_rows(x)
    assert fb.launches.count == no_launch


def test_a_cpu_tensor_never_reaches_the_kernel(no_launch):
    x = torch.from_numpy(_c64(N, seed=9)).reshape(1, -1)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fft_band_rows(x)
    from radiocore_tpu_torch.ops import fft as offt
    got = offt.fft(x, _r(fft_mixed_min=1))
    assert torch.equal(got, torch.fft.fft(x))
    assert fb.launches.count == no_launch


def test_refuses_a_device_without_a_kernel(no_launch):
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fb.fft_band(torch.zeros((1, 2160), dtype=C64, device="meta"))
    assert fb.launches.count == no_launch


# ---- the sources ------------------------------------------------------

def _entry():
    src = SOURCE.read_text()
    params = re.search(r'extern "C" int rc_fft_band\(([^)]*)\)',
                       src).group(1)
    return [" ".join(p.split()) for p in params.split(",")]


def test_the_c_entry_is_the_ctypes_signature():
    decls = _entry()
    kinds = {"void*": build._P, "long long": build._L, "int": build._I,
             "int*": build._P}
    types = [kinds[" ".join(d.replace("const ", "").split()[:-1])]
             if "*" not in d else build._P for d in decls]
    names = [d.split()[-1].lstrip("*") for d in decls]
    assert types == build._SIGNATURES["rc_fft_band"]
    assert names == ["x", "scratch", "y", "batch", "a", "b", "sign", "table",
                     "first", "stream"]


def test_the_geometry_is_the_sources():
    src = SOURCE.read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kBandW"] == fb.SEQUENCES
    assert const["kBandT"] == fb.THREADS
    assert const["kBandMaxL"] == fb.MAX_SIDE == max(fb.CHAINS)
    assert const["kBandUBits"] == fb.U_BITS
    assert const["kBandGroups"] == fb.GROUPS
    assert {c[0] for c in fb.CHAINS.values()} == {const["kBandR0"]}
    # The kernels are instantiated for each chain of CHAINS.
    for L, (r0, r1, r2) in fb.CHAINS.items():
        assert f"band_pass_kernel<ROW, {L}, {r0}, {r1}, {r2}>" in src
    # Two tiles and a pass's stage twiddles fit a block's shared memory.
    assert 8 * (2 * fb.SEQUENCES * fb.MAX_SIDE + fb.MAX_SIDE - 1) <= 232_448


def test_the_probe_variants_match_the_source():
    from radiocore_tpu_torch.tools import fft_band_sweep as sweep
    src = SOURCE.read_text()
    for name, edits in sweep.VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)


def test_imports_without_nvcc_a_card_or_jax():
    mods = {m.name for m in pkgutil.walk_packages(
        __import__("radiocore_tpu_torch").__path__, "radiocore_tpu_torch.")}
    assert "radiocore_tpu_torch.kernels.fft_band" in mods
    env = {k: v for k, v in os.environ.items() if k != "PATH"}
    env.update(PATH="/nonexistent", CUDA_VISIBLE_DEVICES="")
    code = ("import sys, shutil\n"
            "import radiocore_tpu_torch.kernels.fft_band as fb\n"
            "import radiocore_tpu_torch.ops.fft\n"
            "import radiocore_tpu_torch.tools.fft_band_sweep\n"
            "assert shutil.which('nvcc') is None\n"
            "assert 'jax' not in sys.modules\n"
            "from radiocore_tpu_torch.kernels import build\n"
            "assert build._LIB is None and fb.launches.count == 0\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)

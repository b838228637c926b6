"""K-BANDFFT on the card: the 10 MS/s band's transform (10^7 = 3200 ·
3125 points, one and two rows, both signs) against cuFFT in complex128,
its error no worse than twice cuFFT's own in complex64 on the same input;
the input left as it was; the other size routed to it, 3200 · 3200; and
its launches a replayed step of the ``wbfm24`` and ``wbfm48_2band``
steps, none with ``fft_mixed_min = 0``.

Every test here needs a CUDA card and skips without one. This file
imports no JAX, so that it runs where only the port is installed; from
the repository's root on a machine with a card:
``python3 -m pytest tests/test_torch_fft_band_card.py -q -s
--noconftest`` (``tests/conftest.py`` sets JAX up for the CPU tests).
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.card

SEED = (1 << 31) + 2929
N = 10_000_000
STEPS = 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rows(card, rows, n, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.complex(torch.randn(rows, n, generator=gen, device=card),
                         torch.randn(rows, n, generator=gen, device=card))


def _rel_l2(got, want):
    d = got.to(want.dtype) - want
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(want))


def _exact(x, sign):
    x = x.to(torch.complex128)
    if sign < 0:
        return torch.fft.fft(x, dim=-1)
    return torch.fft.ifft(x, dim=-1, norm="forward")


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("sign", [-1.0, 1.0])
def test_the_band_against_complex128(card, rows, sign):
    from radiocore_tpu_torch.kernels import fft_band as fb
    x = _rows(card, rows, N, SEED + rows)
    keep = x.clone()
    before = fb.launches.count
    got = fb.fft_band_rows(x, sign)
    torch.cuda.synchronize()
    assert fb.launches.count == before + 2
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert torch.equal(x, keep), "the kernels wrote their input"
    want = _exact(x, sign)
    err = _rel_l2(got, want)
    lib = _rel_l2(fb.fft_band_plain(x, sign), want)
    print(f"[K-BANDFFT] {rows} x {N} sign {sign:+.0f}: rel_l2 {err:.3e}, "
          f"cuFFT complex64 {lib:.3e}")
    assert err <= 2 * lib


def test_the_other_routed_size(card):
    """3200 · 3200 points, two rows, both signs: the row pass on the
    3200-point chain."""
    from radiocore_tpu_torch.kernels import fft_band as fb
    n = 3200 * 3200
    assert fb.band_split(n) == (3200, 3200)
    x = _rows(card, 2, n, SEED + 11)
    for sign in (-1.0, 1.0):
        want = _exact(x, sign)
        err = _rel_l2(fb.fft_band_rows(x, sign), want)
        lib = _rel_l2(fb.fft_band_plain(x, sign), want)
        print(f"[K-BANDFFT] 2 x {n} sign {sign:+.0f}: rel_l2 {err:.3e}, "
              f"cuFFT complex64 {lib:.3e}")
        assert err <= 2 * lib


def _config(name):
    with open(ROOT / f"portbench/configs/{name}.json") as f:
        return json.load(f)


def _launches_a_step(step, band, state):
    from radiocore_tpu_torch.kernels import fft_band as fb
    for _ in range(2):
        _, state = step(band, state)
    torch.cuda.synchronize()
    before = fb.launches.count
    for _ in range(STEPS):
        _, state = step(band, state)
    torch.cuda.synchronize()
    return (fb.launches.count - before) / STEPS


@pytest.mark.parametrize("routes", [None, {"fft_mixed_min": 0}],
                         ids=["default", "fft_mixed_min=0"])
def test_launches_a_wbfm24_step(card, routes):
    from portbench import signals
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    from radiocore_tpu_torch.runtime import Routes
    config = _config("wbfm24_fast")
    step, state = make_multi_station_step(
        config["band_rate"], signals.offsets(config), config["station_rate"],
        config["audio_rate"], config["deemphasis_s"], mode=config["mode"],
        routes=Routes(**routes) if routes else None, device=card)
    band = _rows(card, 1, N, SEED)[0] * 0.01
    per_step = _launches_a_step(step, band, state)
    assert per_step == (0 if routes else 2)


def test_launches_a_bands_step(card):
    """Both bands' transforms are one launch of each pass."""
    from portbench import bands
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    config = _config("wbfm48_2band")
    step, state = make_multi_station_step(
        config["band_rate"], None, config["station_rate"],
        config["audio_rate"], config["deemphasis_s"], mode=config["mode"],
        bands=bands.band_offsets(config), device=card)
    x = _rows(card, 2, N, SEED) * 0.01
    assert _launches_a_step(step, x, state) == 2

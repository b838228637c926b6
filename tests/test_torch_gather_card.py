"""K-GATHER on the card: the kernel against the torch reorder of the
``native`` route on the same spectrum, the ``auto`` extractor against
``native``, and the launch counter under ``compile_step`` replay, at the
``wbfm24`` plan (a 10^7-bin band, 24 stations of 240 000 points 400 kHz
apart) and at small non-uniform plans.

Every test here needs a CUDA card and skips without one. This file
imports no JAX, so that it runs where only the port is installed; from
the repository's root on a machine with a card:
``python3 -m pytest tests/test_torch_gather_card.py -q --noconftest``
(``tests/conftest.py`` sets JAX up for the CPU tests).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.card

ATOL = 2e-6   # tests/test_torch_extract.py
REL_L2_MAX = 1e-6

WBFM24_N, WBFM24_M = 10_000_000, 240_000
# The wbfm24 configurations' stations: 24, 400 kHz apart, symmetric
# about the centre (portbench/signals.offsets); shift = −offset.
WBFM24_SHIFTS = tuple(-(2 * i - 23) * 200_000 for i in range(24))
# (n, shifts, m, batch): the wbfm24 plan, a small non-uniform plan of an
# odd m (the centre station wraps past bin n − 1), the same over a batch
# of two spectra (odd flat row bases), and an even m at odd starts.
PLANS = {
    "wbfm24": (WBFM24_N, WBFM24_SHIFTS, WBFM24_M, ()),
    "odd_m": (65_536, (0, 9_001, -20_000, 31_000, -7), 4_001, ()),
    "odd_m_batched": (65_536, (0, 9_001, -20_000), 4_001, (2,)),
    "odd_starts": (65_535, (1, 3_001, -12_345), 4_000, ()),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _spectrum(shape, device, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    re = torch.randn(shape, generator=gen, device=device)
    im = torch.randn(shape, generator=gen, device=device)
    return torch.complex(re, im) * 0.3


def _rel_l2(got, want):
    got, want = got.to(torch.complex128), want.to(torch.complex128)
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _max_abs_n(got, want, n):
    """Largest gap of two reorders (each times 1/n) in the spectrum's
    units, where ATOL is the CPU suite's bound."""
    d = got.to(torch.complex128) - want.to(torch.complex128)
    return float(d.abs().max()) * n


def _extractor(plan, impl):
    from radiocore_tpu_torch.ops.channelize import make_extractor
    from radiocore_tpu_torch.runtime import Routes
    n, shifts, m, _ = PLANS[plan]
    return make_extractor(n, shifts, m, Routes(extract_ifft=impl))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_gather_matches_native_reorder(card, plan):
    from radiocore_tpu_torch.kernels import extract
    n, shifts, m, batch = PLANS[plan]
    spec = _spectrum(batch + (n,), card)
    ext = _extractor(plan, "native")
    before = extract.gather_launches.count
    got = ext.gather(spec)
    assert extract.gather_launches.count == before + 1
    want = ext.reorder(spec)
    assert got.shape == want.shape == batch + (len(shifts), m)
    assert _max_abs_n(got, want, n) <= ATOL
    assert _rel_l2(got, want) <= REL_L2_MAX


def test_gather_unaligned_spectrum(card):
    """A spectrum 8 bytes off a 16-byte boundary takes the 8-byte loads."""
    n, shifts, m, _ = PLANS["odd_starts"]
    ext = _extractor("odd_starts", "native")
    spec = _spectrum((n + 1,), card)[1:]
    assert spec.data_ptr() % 16 == 8 and spec.is_contiguous()
    got, want = ext.gather(spec), ext.reorder(spec)
    assert _max_abs_n(got, want, n) <= ATOL
    assert _rel_l2(got, want) <= REL_L2_MAX


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_auto_matches_native(card, plan):
    from radiocore_tpu_torch.kernels import extract
    n, _, _, batch = PLANS[plan]
    spec = _spectrum(batch + (n,), card, seed=5)
    before = extract.gather_launches.count, extract.launches.count
    got = _extractor(plan, "auto")(spec)
    assert (extract.gather_launches.count,
            extract.launches.count) == (before[0] + 1, before[1])
    want = _extractor(plan, "native")(spec)
    assert extract.gather_launches.count == before[0] + 1
    assert float((got - want).abs().max()) <= ATOL
    assert _rel_l2(got, want) <= REL_L2_MAX


def test_counter_under_graph_replay(card):
    """One launch a call of a compiled extraction, warm-up and capture
    uncounted, as the step's other counters."""
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.runtime.graphs import compile_step
    ext = _extractor("wbfm24", "auto")
    step = compile_step(ext, card)
    spec = _spectrum((WBFM24_N,), card)
    before = extract.gather_launches.count
    outs = [step(spec) for _ in range(3)]
    assert extract.gather_launches.count == before + 3
    assert torch.equal(outs[0], outs[2])
    assert torch.equal(outs[0], ext(spec))


def test_wbfm24_step_counts_one_gather(card):
    """The ``off`` multi-station step at the wbfm24 plan, as the
    benchmark's cells build it: one K-GATHER launch a step, no
    K-EXTRACT."""
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    band = _spectrum((WBFM24_N,), card, seed=7)
    offsets = [-s for s in WBFM24_SHIFTS]
    for mode in ("fast", "exact"):
        step, state = make_multi_station_step(
            WBFM24_N, offsets, WBFM24_M, 48_000, 75e-6, mode=mode,
            device=card)
        before = extract.gather_launches.count, extract.launches.count
        for _ in range(3):
            _, state = step(band, state)
        torch.cuda.synchronize()
        assert (extract.gather_launches.count - before[0],
                extract.launches.count - before[1]) == (3, 0), mode


def test_kextract_plan_counts_no_gather(card):
    """A uniform power-of-two plan that K-EXTRACT takes: K-GATHER never
    launches, eager or replayed."""
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.ops.channelize import make_extractor
    from radiocore_tpu_torch.runtime.graphs import compile_step
    c, m = 8, 1 << 14
    n = c * m
    shifts = tuple(n // 2 - m // 2 - i * m for i in range(c))
    ext = make_extractor(n, shifts, m)
    spec = _spectrum((n,), card)
    before = extract.gather_launches.count, extract.launches.count
    ext(spec)
    step = compile_step(ext, card)
    for _ in range(2):
        step(spec)
    assert extract.gather_launches.count == before[0]
    assert extract.launches.count > before[1]

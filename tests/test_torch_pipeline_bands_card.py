"""The multi-band step on the card, at the ``wbfm48_2band`` plan (two 10
MS/s bands of 24 stations of 240 kS/s, each band with its own plan,
``fast``; the pools of the ``resident_bands`` mix): the step against the
float64 reference at the cell's widths, K-GATHER with two plans against
its plain version in complex128 and row for row against the one-plan
gather, one K-GATHER launch a replayed step, and ``pipeline.bands``
under replay.

Every test here needs a CUDA card and skips without one. This file
imports no JAX, so that it runs where only the port is installed; from
the repository's root on a machine with a card:
``python3 -m pytest tests/test_torch_pipeline_bands_card.py -q
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

SEED = (1 << 31) + 2828
# The port in float32 against the float64 chain, as the cell's limits
# hold it (``portbench/configs/wbfm48_2band.json``, ``limits``).
AUDIO_ATOL = 3e-5
REL_L2_MAX = 1e-5     # K-GATHER against its plain version in complex128


@pytest.fixture(scope="module")
def plan():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import bands
    with open(ROOT / "portbench/configs/wbfm48_2band.json") as f:
        config = json.load(f)
    with open(ROOT / "portbench/traffic/resident_bands.json") as f:
        traffic = json.load(f)
    card = torch.device("cuda", 0)
    return config, bands.band_pools(SEED, config, traffic, card), card


def _step(config, card):
    from portbench import bands
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    return make_multi_station_step(
        config["band_rate"], None, config["station_rate"],
        config["audio_rate"], config["deemphasis_s"], mode=config["mode"],
        bands=bands.band_offsets(config), device=card)


def test_cell_widths_against_float64(plan):
    """Two chained chunks at the cell's widths against
    ``references/multi_bands``: the first from the initial state, the
    second after it; audio and carried histories."""
    from portbench.references import multi_bands
    config, pool, card = plan
    step, state = _step(config, card)
    audio, state = step(pool[0], state)
    want = multi_bands.first_answers(config, pool[0], card)
    assert audio.shape == (48, config["audio_rate"], 2)
    assert float((audio.double() - want["audio"]).abs().max()) < AUDIO_ATOL
    audio, state = step(pool[1], state)
    want = multi_bands.answers(config, pool, card)[1]
    for got, key in ((audio, "audio"), (state["deemph_l"], "deemph_l"),
                     (state["deemph_r"], "deemph_r")):
        assert float((got.double() - want[key]).abs().max()) < AUDIO_ATOL
    assert step.band_rows == (range(0, 24), range(24, 48))


def test_gather_with_two_plans(plan):
    """K-GATHER over both bands in one launch: against its plain version
    in complex128, and each band's rows bit for bit what the one-plan
    gather writes for that band alone."""
    from portbench import bands
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.ops import fft as _fft
    from radiocore_tpu_torch.ops.channelize import make_band_extractor
    config, pool, card = plan
    n, m = config["band_rate"], config["station_rate"]
    spectra = _fft.fft(pool[0])
    ex = make_band_extractor(n, [[-o for o in offs] for offs in
                                 bands.band_offsets(config)], m)
    before = extract.gather_launches.count
    got = ex.gather(spectra)
    torch.cuda.synchronize()
    assert extract.gather_launches.count - before == 1
    starts, window, fix = ex.by_band[0].gather_plan
    at = torch.tensor([b * n + a for b, e in enumerate(ex.by_band)
                       for a in e.gather_plan[0]], device=card)
    want = extract.extract_gather_rows_plain(
        spectra.to(torch.complex128), at, window.on(card).double(), fix)
    err = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert err < REL_L2_MAX
    for b, e in enumerate(ex.by_band):
        alone = e.gather(spectra[b])
        assert torch.equal(got[24 * b:24 * (b + 1)], alone), b


def test_one_gather_launch_and_bands_counted_under_replay(plan):
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.parallel import pipeline
    config, pool, card = plan
    step, state = _step(config, card)
    _, state = step(pool[0], state)         # warm-up and capture
    torch.cuda.synchronize()
    gathers = extract.gather_launches.count
    stepped = pipeline.bands.count
    for k in range(1, 4):
        _, state = step(pool[k], state)
    torch.cuda.synchronize()
    assert extract.gather_launches.count - gathers == 3
    assert pipeline.bands.count - stepped == 6
    assert step.graph_count == 1


def test_graph_matches_its_eager_body(plan):
    config, pool, card = plan
    step, state = _step(config, card)
    graphed, eager = state, state
    for k in range(3):
        a_g, graphed = step(pool[k], graphed)
        a_e, eager = step.eager(pool[k], eager)
        assert torch.equal(a_g, a_e), k
        for key in graphed:
            assert torch.equal(graphed[key], eager[key]), (k, key)


def test_a_band_on_k_extract_goes_there_as_alone():
    """A batch whose band A takes a uniform power-of-two plan: the band
    extractor sends each band to its own extractor (K-EXTRACT for A,
    K-GATHER for B), so every row is bit for bit that band's alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from radiocore_tpu_torch.kernels import extract
    from radiocore_tpu_torch.ops.channelize import (make_band_extractor,
                                                    make_extractor)
    n, m = 8192, 512
    plans = [[-(2 * i - 3) * m // 2 for i in range(4)], [1500, 0, -2600]]
    gen = torch.Generator().manual_seed(28)
    spectra = torch.complex(torch.randn(2, n, generator=gen),
                            torch.randn(2, n, generator=gen)).to("cuda")
    ex = make_band_extractor(n, plans, m)
    assert not ex.gather_route(spectra)
    before = (extract.launches.count, extract.gather_launches.count)
    got = ex(spectra)
    torch.cuda.synchronize()
    assert extract.launches.count > before[0]
    assert extract.gather_launches.count - before[1] == 1
    want = torch.cat([make_extractor(n, p, m)(spectra[b])
                      for b, p in enumerate(plans)])
    assert torch.equal(got, want)

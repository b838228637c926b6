"""The config-5 rehearsal of tests/test_config5.py in one process: 128
stations of 50 000 S/s to 10 000 audio samples in a 6.4 M band of
``SyntheticFmSource`` stations, through the port and through the JAX
package on the same band, in ``exact`` and ``fast``: the audio within
4e-5 abs (the bound of tests/test_pipeline_pallas.py) and the tones of
stations 0, 64 and 127 above 6 dB (the bound of tests/test_config5.py).
50 000 is not a power of two: the plain extraction and the library's
transforms serve this plan."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracles

torch.set_num_threads(2)

N_STATIONS = 128
STATION_CHUNK = 50_000
AUDIO_CHUNK = 10_000
N_BAND = N_STATIONS * STATION_CHUNK
ATOL = 4e-5
TONE_MIN_DB = 6.0


def _plan():
    half = N_BAND // 2 - STATION_CHUNK // 2
    offsets = [int(-half + i * STATION_CHUNK) for i in range(N_STATIONS)]
    tones = [(300.0 + (i % 40) * 90.0, 800.0 + (i % 40) * 90.0)
             for i in range(N_STATIONS)]
    return offsets, tones


@pytest.fixture(scope="module")
def band():
    from radiocore_tpu_torch.apps.iq import SyntheticFmSource
    offsets, tones = _plan()
    src = SyntheticFmSource(N_BAND, offsets, STATION_CHUNK, tones=tones)
    return src.read_chunk(1.0)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_128_stations_match_jax(band, mode):
    from radiocore_tpu.parallel.pipeline import (
        make_multi_station_step as jax_step)
    from radiocore_tpu_torch.parallel.pipeline import make_multi_station_step
    offsets, tones = _plan()
    step_j, state_j = jax_step(N_BAND, offsets, STATION_CHUNK, AUDIO_CHUNK,
                               mode=mode)
    want = np.asarray(step_j(jnp.asarray(band), state_j)[0])
    step_t, state_t = make_multi_station_step(
        N_BAND, offsets, STATION_CHUNK, AUDIO_CHUNK, mode=mode, device="cpu")
    got = step_t(torch.from_numpy(band), state_t)[0].numpy()
    assert got.shape == (N_STATIONS, AUDIO_CHUNK, 2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    for i in (0, N_STATIONS // 2, N_STATIONS - 1):
        for ch, f in enumerate(tones[i]):
            snr = oracles.tone_snr_db(got[i, 500:-500, ch], AUDIO_CHUNK, f)
            assert snr > TONE_MIN_DB, (i, ch, snr)

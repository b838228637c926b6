"""Where the ``fast`` multi-station step's station rfft goes in the
``off`` and ``fused`` modes. The reference's ``fused`` path ignores
``RADIOCORE_TPU_STATION_RFFT``; the port keeps K-FFT's ``rfft_pow2`` there
on the card by default, and ``station_rfft="native"`` gives the
reference's route with no ``rfft_pow2`` call."""

import numpy as np
import pytest
import torch

from radiocore_tpu_torch.kernels import fft_rows
from radiocore_tpu_torch.parallel import pipeline
from radiocore_tpu_torch.parallel.pipeline import (make_multi_station_step,
                                                   station_rfft_route)
from radiocore_tpu_torch.runtime.routes import Routes

torch.set_num_threads(2)

C, SC, AC = 4, 65_536, 16_384


@pytest.mark.parametrize("sc,station_rfft,kernel_min,is_cuda,slot", [
    (262_144, "auto", 1 << 24, True, "rows"),     # the card's default
    (262_144, "pallas", 1 << 24, True, "rows"),
    (262_144, "native", 1 << 24, True, "torch"),  # the reference's fused
    (262_144, "native", 1 << 16, True, "rows"),   # ops.fft.rfft's route
    (262_144, "auto", 1 << 24, False, "torch"),
    (262_144, "pallas", 1 << 24, False, "rows"),  # the plain version
    (262_144, "native", 1 << 24, False, "torch"),
    (50_000, "auto", 1 << 24, True, "torch"),     # no K-FFT row
    (50_000, "pallas", 1 << 24, True, "torch"),
])
def test_station_rfft_route(sc, station_rfft, kernel_min, is_cuda, slot):
    routes = Routes(station_rfft=station_rfft, fft_kernel_min=kernel_min)
    assert station_rfft_route(sc, is_cuda, routes) == slot


def test_default_route_is_the_kernel_on_the_card():
    assert station_rfft_route(262_144, True) == "rows"
    assert station_rfft_route(262_144, True, Routes()) == "rows"


def _fm_band(rng):
    """An FM station in every slot of the band (noise makes the demod
    ill-conditioned)."""
    n = C * SC
    spec = np.zeros(n, np.complex128)
    half = n // 2 - SC // 2
    for i in range(C):
        phase = np.cumsum(0.25 * np.pi * np.sin(
            2 * np.pi * (300 + 100 * i) * np.arange(SC) / SC
            + rng.uniform(0, 2 * np.pi)))
        st = np.fft.fftshift(np.fft.fft(np.exp(1j * phase)))
        start = ((-half + i * SC) % n - SC // 2) % n
        spec[start:start + SC] = st
    return np.fft.ifft(spec).astype(np.complex64)


@pytest.mark.parametrize("extract_demod", ["off", "fused"])
def test_step_calls_rfft_pow2_only_on_its_route(monkeypatch, extract_demod):
    """Both modes on the CPU under ``"pallas"`` (what ``"auto"`` is on the
    card) and ``"native"``: one ``rfft_pow2`` call a step, or none; the
    audio is the same."""
    calls = []
    real = fft_rows.rfft_pow2

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(fft_rows, "rfft_pow2", counted)
    assert pipeline.fft_rows is fft_rows
    offs = [int(-(C * SC // 2 - SC // 2) + i * SC) for i in range(C)]
    band = torch.from_numpy(_fm_band(np.random.default_rng(5)))
    audio = {}
    for impl, want_calls in (("pallas", [(C, SC)]), ("native", []),
                             ("auto", [])):
        calls.clear()
        step, state = make_multi_station_step(
            C * SC, offs, SC, AC, mode="fast", extract_demod=extract_demod,
            device="cpu", routes=Routes(station_rfft=impl))
        audio[impl], _ = step(band, state)
        assert calls == want_calls, impl
    torch.testing.assert_close(audio["pallas"], audio["native"], rtol=0,
                               atol=4e-5)
    torch.testing.assert_close(audio["auto"], audio["native"], rtol=0,
                               atol=0)

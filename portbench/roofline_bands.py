"""The bounds of the multi-band step's shares (``bands_fft_roofline``,
``gather_roofline``), by ``portbench/roofline.py``'s rules: each input
byte read once and each output byte written once at the card's peak
memory rate, or the operations at its float32 peak."""

from __future__ import annotations

from portbench import roofline


def bands_fft_bound_ms(config: dict, device_name: str) -> float:
    """The band FFT over the batch: ``bands`` times one band's bound."""
    return int(config["bands"]) * roofline.band_fft_bound_ms(config,
                                                             device_name)


def check_bands_fft_floor(config: dict, ms: float, device_name: str) -> None:
    """Refuse a batch's band-FFT time shorter than one read and one write
    of every band at the peak memory rate."""
    n = int(config["bands"]) * int(config["band_rate"])
    floor = (2 * n * roofline.C64
             / roofline.peaks(device_name)["bytes_per_s"] * 1e3)
    if not ms >= floor:
        raise roofline.BelowFloor(f"the bands' FFT timed at {ms} ms, below "
                                  f"the {floor} ms one read and write of "
                                  f"the bands take at peak")


def gather_bound_ms(config: dict, device_name: str) -> float:
    """K-GATHER over every band's stations: each station's kept bins read
    once and its complex64 IQ written once (it does no transform)."""
    c, m = int(config["stations"]), int(config["station_rate"])
    return roofline.bound_ms(2 * c * m * roofline.C64, 0.0, device_name)

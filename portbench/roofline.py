"""The yardstick of the roofline shares: each card's published peaks, and
the least bytes and operations of each stage whose share is read.

A stage's bound is the larger of its bytes at the peak memory rate (each
input byte read once, each output byte written once) and its operations
at the peak float32 rate outside the tensor cores. Its share is that
bound over the stage's measured time. The work is the stage's, whatever
implements it.
"""

from __future__ import annotations

import math
from typing import Dict

# Published dense peaks (NVIDIA's data sheets), by the name
# ``torch.cuda.get_device_name()`` gives. A card not listed is refused.
PEAKS: Dict[str, Dict[str, float]] = {
    # H100 SXM5: 3.35 TB/s HBM3, 67 TFLOP/s float32 (non-tensor), 700 W.
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12},
}

C64 = 8   # bytes of one complex64 sample


class UnknownCard(RuntimeError):
    """The peaks table does not know the card."""


def peaks(device_name: str) -> Dict[str, float]:
    try:
        return PEAKS[device_name]
    except KeyError:
        raise UnknownCard(f"no published peaks for {device_name!r}; known: "
                          f"{sorted(PEAKS)}") from None


def fft_flops(n: int, rows: int = 1) -> float:
    """The conventional ``5 n log2 n`` operations of a complex DFT."""
    return 5.0 * n * math.log2(n) * rows


def bound_ms(nbytes: float, flops: float, device_name: str) -> float:
    p = peaks(device_name)
    return max(nbytes / p["bytes_per_s"], flops / p["f32_flop_per_s"]) * 1e3


def band_fft_bound_ms(config: dict, device_name: str) -> float:
    """The band FFT: the complex64 band read once and its spectrum
    written once, or ``5 n log2 n`` operations."""
    n = int(config["band_rate"])
    return bound_ms(2 * n * C64, fft_flops(n), device_name)


def extract_bound_ms(config: dict, device_name: str) -> float:
    """The extraction: each station's kept bins read once and its
    complex64 IQ written once, or the stations' inverse DFTs."""
    c, m = int(config["stations"]), int(config["station_rate"])
    return bound_ms(2 * c * m * C64, fft_flops(m, c), device_name)


class BelowFloor(RuntimeError):
    """A stage time below what the card can do: the timing is wrong."""


def check_band_fft_floor(config: dict, ms: float, device_name: str) -> None:
    """Refuse a band-FFT time shorter than one read and one write of the
    band at the peak memory rate (the timing missed the work)."""
    n = int(config["band_rate"])
    floor = 2 * n * C64 / peaks(device_name)["bytes_per_s"] * 1e3
    if not ms >= floor:
        raise BelowFloor(f"band FFT timed at {ms} ms, below the {floor} ms "
                         f"one read and write of the band take at peak")

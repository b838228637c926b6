"""The floor of a serial recurrence, the yardstick of ``nco_roofline``:
K-NCO's feedback loop (``csrc/nco_pll.cu``), one row of samples a
thread, each sample's phase depending on the one before it.

The floor is the larger of two bounds. By bytes: the pilot read once and
the phase trajectory written once, float32, at the card's peak memory
rate (``portbench/roofline.py``). By the chain: a row's samples, each at
least one dependent arithmetic instruction, at 4 cycles for the
dependent issue of a register-operand arithmetic instruction (CUDA C++
Programming Guide, "Multiprocessor Level") and the card's published boost
clock. Any implementation of the recurrence takes at least one dependent
operation a sample, so the share cannot pass 100%.
"""

from __future__ import annotations

from typing import Dict

from portbench import roofline

F32 = 4                 # bytes of one float32 sample
DEPENDENT_CYCLES = 4    # issue latency of a dependent arithmetic instruction

# Published boost SM clocks, by ``torch.cuda.get_device_name()``.
CLOCKS_HZ: Dict[str, float] = {
    # H100 SXM5: 1 980 MHz boost (PERF.md §2 saw it held under load).
    "NVIDIA H100 80GB HBM3": 1.98e9,
}


def chain_ms(samples: int, device_name: str) -> float:
    """``samples`` dependent instructions in one thread, at the boost
    clock."""
    try:
        clock = CLOCKS_HZ[device_name]
    except KeyError:
        raise roofline.UnknownCard(f"no published clock for "
                                   f"{device_name!r}") from None
    return samples * DEPENDENT_CYCLES / clock * 1e3


def nco_floor_ms(config: dict, device_name: str) -> float:
    """K-NCO over one chunk of every station: ``stations`` rows of
    ``station_rate`` samples."""
    c, n = int(config["stations"]), int(config["station_rate"])
    by_bytes = roofline.bound_ms(2 * c * n * F32, 0.0, device_name)
    return max(by_bytes, chain_ms(n, device_name))

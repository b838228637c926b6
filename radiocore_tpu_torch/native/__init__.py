"""Native (C++) host components of the port, loaded via ctypes.

Builds the port's own ``ringbuffer.cpp`` and ``iqconvert.cpp`` at first
use with the system C++ compiler into ``radiocore_tpu_torch/_build/``;
every consumer degrades to its pure Python version when no toolchain is
available (mirrors ``radiocore_tpu.native``).
"""

from radiocore_tpu_torch.native.build import (NativeRing, iq_convert_native,
                                              iq_f32_to_s16_native,
                                              iq_native_available,
                                              load_native_ring,
                                              native_available)

__all__ = ["NativeRing", "iq_convert_native", "iq_f32_to_s16_native",
           "iq_native_available", "load_native_ring", "native_available"]

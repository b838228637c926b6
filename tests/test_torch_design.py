"""The port's copy of ops/design.py is bit-equal to the JAX package's for
every design the slice uses."""

import numpy as np
import pytest

from radiocore_tpu.ops import design as jd
from radiocore_tpu_torch.ops import design as td

N_STATION, N_AUDIO, N_BAND = 262_144, 49_152, 1 << 24


@pytest.mark.parametrize("name,args", [
    ("window", ("hann", N_BAND)),
    ("window", ("hann", 2048)),
    ("resample_window", ("hamm", N_STATION)),
    ("resample_window", ("hamm", 65_536)),
    ("bandpass_taps", (41, 19e3 - 50, 19e3 + 50, N_STATION)),
    ("bandpass_taps", (41, 19e3 - 50, 19e3 + 50, 65_536)),
    ("deemphasis_taps", (N_AUDIO, 75e-6)),
    ("deemphasis_taps", (16_384, 50e-6, 51)),
    ("hilbert_multiplier", (4096,)),
    ("fir_step_history", (np.ones(51),)),
])
def test_bit_equal(name, args):
    want = getattr(jd, name)(*args)
    got = getattr(td, name)(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)

"""Demodulator model family of the PyTorch port: FM, MFM, WBFM and the
filter classes (mirrors ``radiocore_tpu.models``).

Each demodulator exists as a functional step ``(chunk, state) → (audio,
state)`` built by ``make_*_step``, batch-generic over leading axes, and
as a thin stateful class with the reference's ``run(sig, numpy_output)``
API that runs on a named device.
"""

from radiocore_tpu_torch.models.fm import FM, make_fm_step
from radiocore_tpu_torch.models.mfm import MFM, make_mfm_step
from radiocore_tpu_torch.models.wbfm import (WBFM, make_wbfm_step,
                                             wbfm_init_state)
from radiocore_tpu_torch.models.bandpass import Bandpass
from radiocore_tpu_torch.models.decimate import Decimate
from radiocore_tpu_torch.models.deemphasis import Deemphasis
from radiocore_tpu_torch.models.pll import PLL

__all__ = [
    "FM", "MFM", "WBFM", "Bandpass", "Decimate", "Deemphasis", "PLL",
    "make_fm_step", "make_mfm_step", "make_wbfm_step", "wbfm_init_state",
]

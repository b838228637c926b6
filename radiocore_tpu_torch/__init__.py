"""radiocore_tpu_torch: the PyTorch + CUDA port of ``radiocore_tpu``.

Mirrors the JAX package's module paths (``ops/``, ``kernels/``,
``models/``, ``parallel/``, ``runtime/``) so each counterpart is easy to
find; the JAX package stays the reference the port is tested against.
Imports ``torch`` and never ``jax``. Kernels are CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use (``kernels/build.py``).
"""

from radiocore_tpu_torch.models import (FM, MFM, PLL, WBFM, Bandpass,
                                        Decimate, Deemphasis, make_fm_step,
                                        make_mfm_step, make_wbfm_step,
                                        wbfm_init_state)

__version__ = "0.1.0"

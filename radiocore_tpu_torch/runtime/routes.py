"""Which kernel or library call serves each routed slot: one frozen,
hashable :class:`Routes` object, read once and passed down.

The JAX package reads these choices from the environment wherever it
uses them; here only the apps' ``main()`` reads it
(:meth:`Routes.from_environ`), and every library entry point takes
``routes=`` (None means ``Routes()``, the reference's defaults). The
fields, the variables they come from and the spellings are the JAX
package's:

- ``fft_kernel_min`` (``RADIOCORE_TPU_FFT_PALLAS_MIN``, 2^24; 0
  disables): power-of-two complex64 transforms on the card of at least
  this size go to K-FFT (``ops/fft``);
- ``fft_mixed_min`` (``RADIOCORE_TPU_FFT_MIXED_MIN``, 2^23; 0 disables):
  sizes ``a·2^k`` on the card of at least this size go to K-MIXED, and
  other sizes of at least it with a ``band_split`` (10^7 and 3200², no
  size of a station-rate transform) to K-BANDFFT; 0 sends both back to
  cuFFT;
- ``extract_ifft`` (``RADIOCORE_TPU_EXTRACT_IFFT``): the extraction's
  inverse transform (``ops/channelize``);
- ``station_rfft`` (``RADIOCORE_TPU_STATION_RFFT``): the station rfft
  of the ``fast`` multi-station step (``parallel/pipeline``) in its
  ``off`` and ``fused`` modes. The reference's ``fused`` path ignores the
  variable and takes its library transform; here ``fused`` follows the
  field as ``off`` does, so ``"auto"`` runs K-FFT's ``rfft_pow2`` on the
  card in both, on purpose: it beat cuFFT's rfft at 64 × 2^18 (0.173
  against 0.196 ms, NVIDIA H100 80GB HBM3, 700 W, ``chip_smoke.py``),
  and every ``fused`` time on record was taken with it. ``"native"``
  gives the reference's ``fused`` route (no ``rfft_pow2`` launch);
- ``env_fft`` (``RADIOCORE_TPU_ENV_FFT``): the envelope-rate transforms
  of the ``fast`` WBFM tail (``models/wbfm``);
- ``fir_impl`` (``RADIOCORE_TPU_FIR_IMPL``): what ``ops.fir.fir_causal``
  runs for ``impl="auto"``.

The reference's TPU-only switches (the native-FFT probe, its
``set_policy`` and ``RADIOCORE_TPU_FFT_FOURSTEP_MIN``, the MXU
precisions, the extraction preroll, the compile cache) have no field:
ROADMAP.md says why.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

# Field → (the reference's variable, the values it takes).
CHOICES = {
    "extract_ifft": ("RADIOCORE_TPU_EXTRACT_IFFT",
                     ("auto", "native", "fourstep", "pallas", "fused")),
    "station_rfft": ("RADIOCORE_TPU_STATION_RFFT",
                     ("auto", "pallas", "native")),
    "env_fft": ("RADIOCORE_TPU_ENV_FFT", ("native", "pallas")),
    "fir_impl": ("RADIOCORE_TPU_FIR_IMPL", ("pallas", "fft", "conv")),
}
THRESHOLDS = {
    "fft_kernel_min": "RADIOCORE_TPU_FFT_PALLAS_MIN",
    "fft_mixed_min": "RADIOCORE_TPU_FFT_MIXED_MIN",
}


@dataclasses.dataclass(frozen=True)
class Routes:
    """The route of every slot; the defaults are the reference's."""

    fft_kernel_min: int = 1 << 24
    fft_mixed_min: int = 1 << 23
    extract_ifft: str = "auto"
    station_rfft: str = "auto"
    env_fft: str = "native"
    fir_impl: str = "pallas"

    def __post_init__(self):
        for name in THRESHOLDS:
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int) or v < 0:
                raise ValueError(f"Routes.{name}={v!r}: expected an int "
                                 f">= 0 (0 disables)")
        for name, (_, values) in CHOICES.items():
            v = getattr(self, name)
            if v not in values:
                raise ValueError(f"Routes.{name}={v!r}: expected one of "
                                 f"{', '.join(values)}")

    @classmethod
    def from_environ(cls, environ: Optional[Mapping[str, str]] = None
                     ) -> "Routes":
        """The routes the reference's variables in ``environ``
        (``os.environ`` when None) select; an unset variable keeps its
        default. A threshold parses as the reference parses it
        (``int(float(v))``, so ``"65536"`` and ``"6.5e4"`` both do; 0 or
        less disables). Anything else raises ``ValueError`` naming the
        variable."""
        env = os.environ if environ is None else environ
        kw = {}
        for name, var in THRESHOLDS.items():
            raw = env.get(var)
            if raw is None:
                continue
            try:
                v = int(float(raw))
            except (ValueError, OverflowError):
                raise ValueError(f"{var}={raw!r}: expected a number "
                                 f"(0 disables)") from None
            kw[name] = max(v, 0)
        for name, (var, values) in CHOICES.items():
            raw = env.get(var)
            if raw is None:
                continue
            if raw not in values:
                raise ValueError(f"{var}={raw!r}: expected one of "
                                 f"{', '.join(values)}")
            kw[name] = raw
        return cls(**kw)


DEFAULT = Routes()


def resolve(routes: Optional[Routes]) -> Routes:
    """``routes``, or the defaults for None."""
    if routes is None:
        return DEFAULT
    if not isinstance(routes, Routes):
        raise TypeError(f"routes: expected a Routes, got {type(routes)!r}")
    return routes


def at_least(n: int, threshold: int) -> bool:
    """``n`` reaches a threshold field (0: never)."""
    return threshold > 0 and n >= threshold

"""Frozen, hashable configuration dataclasses; a copy of
``radiocore_tpu/runtime/config.py`` (the port imports nothing of the JAX
package).

The reference scatters per-example ``@dataclass Config`` blocks with
inline constants (reference: ``examples/receive_fm.py:12-21``,
``examples/multi_fm_server.py:19-29``). Here configuration is a single
frozen tree, so instances are hashable.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class StationConfig:
    """One broadcast-FM station inside a channelized band."""

    frequency: float            # RF center frequency, Hz
    bandwidth: float = 240e3    # channel bandwidth, Hz (== channel sample rate)
    mode: str = "wbfm"          # "fm" | "mfm" | "wbfm"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for a sharded pipeline: ``stations`` is the
    embarrassingly-parallel data axis, ``time`` shards the 1-second sample
    axis with FIR halo exchange."""

    stations: int = 1
    time: int = 1

    @property
    def n_devices(self) -> int:
        """Total devices the mesh spans (stations × time)."""
        return self.stations * self.time


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end receive pipeline configuration.

    The one-second-chunk convention of the reference
    (reference: ``radiocore/tools/tuner.py:43-44``) is kept as the default
    (``chunk_seconds == 1.0`` → buffer size == sample rate → Hz == FFT bin)
    but is explicit and overridable here.
    """

    input_rate: float = 10e6          # SDR sample rate, S/s
    center_frequency: float = 96.9e6  # band center, Hz
    demod_rate: float = 250e3         # per-station IQ rate after channelize
    audio_rate: float = 48e3          # audio output rate
    deemphasis: float = 75e-6         # 75 µs Americas / 50 µs elsewhere
    chunk_seconds: float = 1.0
    stations: Tuple[StationConfig, ...] = ()
    mesh: MeshConfig = MeshConfig()
    dtype: str = "complex64"

    @property
    def chunk_size(self) -> int:
        """IQ samples per chunk at the SDR input rate."""
        return int(self.input_rate * self.chunk_seconds)

    @property
    def demod_chunk(self) -> int:
        """IQ samples per chunk at the per-station demod rate."""
        return int(self.demod_rate * self.chunk_seconds)

    @property
    def audio_chunk(self) -> int:
        """Audio samples per chunk per station."""
        return int(self.audio_rate * self.chunk_seconds)

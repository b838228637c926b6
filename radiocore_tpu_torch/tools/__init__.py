"""Streaming and memory tools of the port (mirrors
``radiocore_tpu.tools``): the host ring, buffers, chunkers and the
channelizer. The measurement scripts ``extract_sweep`` and ``fir_sweep``
also live here and run as ``python3 -m``."""

from radiocore_tpu_torch.tools.buffer import Buffer
from radiocore_tpu_torch.tools.ringbuffer import RingBuffer
from radiocore_tpu_torch.tools.carrousel import Carrousel
from radiocore_tpu_torch.tools.chopper import Chopper
from radiocore_tpu_torch.tools.tuner import Channel, Tuner

__all__ = ["Buffer", "RingBuffer", "Carrousel", "Chopper", "Tuner", "Channel"]

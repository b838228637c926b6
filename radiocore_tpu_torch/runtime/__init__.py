"""Runtime layer of the PyTorch port (mirrors ``radiocore_tpu.runtime``):
platform probing, configuration, metrics, host ↔ device copies and
checkpoints."""

from radiocore_tpu_torch.runtime.platform import (HasCuda, has_cuda,
                                                  platform_summary)
from radiocore_tpu_torch.runtime.config import (MeshConfig, PipelineConfig,
                                                StationConfig)
from radiocore_tpu_torch.runtime.metrics import Metrics
from radiocore_tpu_torch.runtime.transfer import to_device_c64, to_host
from radiocore_tpu_torch.runtime.checkpoint import load_state, save_state

__all__ = [
    "has_cuda", "HasCuda", "platform_summary",
    "PipelineConfig", "StationConfig", "MeshConfig", "Metrics",
    "save_state", "load_state", "to_device_c64", "to_host",
]

"""The parallel layer of the PyTorch port (mirrors
``radiocore_tpu.parallel``): a ``(stations, time)`` rank mesh over a
``torch.distributed`` world, halo exchange for time-sharded filters, the
distributed band FFT and channel extraction, and the multi-station step
on one device or over a mesh.

* **station axis**: independent FM stations shard like a batch axis (no
  collectives after the channelizer);
* **time axis**: the sample axis shards like a sequence axis; filters
  exchange ``num_taps−1``-sample halos with their neighbours;
* the band FFT runs as a six-step FFT over the ranks
  (``fft_sharded``, ``channelize_sharded``), or after an all-gather.
"""

from radiocore_tpu_torch.parallel.mesh import (make_radio_mesh,
                                               station_sharding)
from radiocore_tpu_torch.parallel.halo import (halo_exchange,
                                               fir_causal_sharded,
                                               zero_phase_fir_sharded)
from radiocore_tpu_torch.parallel.pipeline import (gather_stations,
                                                   make_multi_station_step)
from radiocore_tpu_torch.parallel.fft_sharded import (fft_sharded_auto,
                                                      fft_sharded_fourstep)

__all__ = [
    "make_radio_mesh", "station_sharding",
    "halo_exchange", "fir_causal_sharded", "zero_phase_fir_sharded",
    "make_multi_station_step", "gather_stations",
    "fft_sharded_auto", "fft_sharded_fourstep",
]

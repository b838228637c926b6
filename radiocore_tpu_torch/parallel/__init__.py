"""parallel of the PyTorch port (mirrors radiocore_tpu.parallel)."""

"""runtime of the PyTorch port (mirrors radiocore_tpu.runtime)."""

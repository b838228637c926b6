"""kernels of the PyTorch port (mirrors radiocore_tpu.kernels)."""

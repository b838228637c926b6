"""ops of the PyTorch port (mirrors radiocore_tpu.ops)."""

"""models of the PyTorch port (mirrors radiocore_tpu.models)."""

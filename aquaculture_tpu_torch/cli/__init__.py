"""Sub-package of the PyTorch port (see aquaculture_tpu_torch)."""

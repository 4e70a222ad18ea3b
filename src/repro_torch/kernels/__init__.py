"""repro_torch.kernels — build and load of the CUDA sources in ``csrc/``."""

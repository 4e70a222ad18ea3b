"""repro_torch.kernels — the hand kernels K2–K7 (``ops``), their plain
versions (``ref``), and the build and load of the CUDA sources in
``csrc/``."""

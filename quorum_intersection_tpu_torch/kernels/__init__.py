"""The port's CUDA kernels (``csrc/``), their build, their plain PyTorch
versions."""

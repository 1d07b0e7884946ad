"""The fused sweep: CUDA kernel (``csrc/sweep.cu``), its build, its plain
PyTorch version."""

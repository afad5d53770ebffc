"""Hand-written CUDA kernels (``csrc/``) with their PyTorch wrappers and
plain versions."""

"""Hand-written CUDA kernels (sources in ``csrc/``), their build and their
PyTorch wrappers, each beside its plain PyTorch version."""

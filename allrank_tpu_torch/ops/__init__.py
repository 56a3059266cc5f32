"""Hand-written CUDA kernels for the serving path, each beside its plain
PyTorch version (used for CPU tensors and as the kernel's reference)."""

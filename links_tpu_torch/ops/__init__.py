"""Hand-written CUDA kernels and their wrappers (built at first use)."""

"""PyTorch port of links_tpu for NVIDIA GPUs (H100).

Plain tensor code is PyTorch; the TPU Pallas kernels of links_tpu become
hand-written CUDA kernels under ``ops/csrc``. This package imports neither
jax nor links_tpu: the JAX package is the reference the tests hold it against.
"""

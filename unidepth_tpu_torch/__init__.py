"""PyTorch + CUDA port of unidepth_tpu for NVIDIA Hopper.

The JAX package ``unidepth_tpu`` is the reference; this package mirrors its
module paths. It imports torch, numpy and the standard library only. Its
three hand-written CUDA kernels (``csrc/``) are built with nvcc at the first
CUDA call; CPU tensors take each kernel's plain PyTorch version.
"""

"""PyTorch + CUDA port of unidepth_tpu for NVIDIA Hopper.

The JAX package ``unidepth_tpu`` is the reference; this package mirrors its
module paths and runs UniDepthV2 (DINOv2 ViT-S/B/L) and UniDepthV1 (DINOv2
ViT-L, ConvNeXt-L) with any camera model of ``geometry/cameras.py``,
trains UniDepthV2 on one device (``training/``) and evaluates both
(``utils/validation.py``).
It imports torch, numpy and the standard library only.
Its hand-written CUDA kernels (``csrc/``) are built with nvcc at the first
CUDA call; CPU tensors take each kernel's plain PyTorch version.
"""

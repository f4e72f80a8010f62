"""PyTorch + CUDA port of unidepth_tpu for NVIDIA Hopper.

The JAX package ``unidepth_tpu`` is the reference; this package mirrors its
module paths and runs UniDepthV2 (DINOv2 ViT-S/B/L), UniDepthV1 (DINOv2
ViT-L, ConvNeXt-L) and UniDepthV2old (DINOv2 ViT-S/L; ``hubconf.UniDepth``
builds any of the seven) with any camera model of ``geometry/cameras.py``,
trains every family on one device or over several processes with data,
FSDP and tensor parallelism (``training/``, ``parallel/``) from HDF5
shards (``datasets/``) and evaluates them (``utils/validation.py``).
It imports torch, numpy and the standard library; h5py is imported where a
shard is opened and PIL where a non-PNG image is decoded. Its host-side C
helpers (``native/``) are built with the system C compiler at first use.
Its hand-written CUDA kernels (``csrc/``) are built with nvcc at the first
CUDA call; CPU tensors take each kernel's plain PyTorch version.
"""

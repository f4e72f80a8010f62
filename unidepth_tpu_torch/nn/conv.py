"""Convolution helpers (counterpart of unidepth_tpu/nn/conv.py).

NCHW, as ``nn.Conv2d`` takes it. The JAX package leaves these to XLA, so
here they are cuDNN convolutions.
"""

from __future__ import annotations

import torch.nn as nn

PADDING_MODES = ("zeros", "reflect", "replicate")


class Conv2d(nn.Conv2d):
    """Stride-1 conv with symmetric padding (default: same size for odd
    kernels) in torch's padding modes zeros / reflect / replicate."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        padding: int | None = None,
        padding_mode: str = "zeros",
        bias: bool = True,
    ):
        if padding_mode not in PADDING_MODES:
            raise ValueError(f"padding_mode {padding_mode!r} not in {PADDING_MODES}")
        pad = (kernel_size - 1) // 2 if padding is None else padding
        super().__init__(
            in_channels, out_channels, kernel_size, padding=pad, padding_mode=padding_mode, bias=bias
        )


class PatchConvTranspose(nn.ConvTranspose2d):
    """ConvTranspose2d with kernel_size == stride == ``scale``: every input
    pixel becomes an independent ``scale x scale`` output patch
    (``scale == 1`` is a 1x1 conv)."""

    def __init__(self, in_channels: int, out_channels: int, scale: int):
        super().__init__(in_channels, out_channels, kernel_size=scale, stride=scale)

"""The V2 heads' LayerNorm -> Linear pair in one launch: the CUDA kernel
``csrc/head_mlp_wgmma.cu`` (kernel K2h) and its plain PyTorch version.

``DepthHead`` (``models/unidepthv2/decoder.py``) runs ``depth_mlp`` and
``confidence_mlp``, each ``Linear(LayerNorm(x))`` of width C, on the same
latents: the NCHW (B, C, H, W) map the feature pyramid leaves. ``head_mlp``
computes both heads (or one) from those latents as they lie and returns
each head's (B, H, W, C) map, the layout ``nn.Linear`` writes on the
permuted latents. No TPU kernel is replaced: the JAX package runs the two
as modules.

On the H100 the pair is bound by memory (at 518x518, B = 8 and C = 128,
179 MB read and 359 MB written against 46 GFLOP: 0.161 ms at 3.35 TB/s).
The kernel reads the latents once, computes each pixel's statistics once
for both heads, normalises the wgmma A operand in registers and writes
each head's output once (see the source). It takes bf16 with C 64 or 128
and H * W a multiple of 64 (``fits``), bf16 parameters, and no gradient:
the decoder routes nothing else here. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.

``head_mlp.launches`` counts the launches (a CUDA graph's capture counts,
its replays do not); each runs in the host span ``unidepth.kernel.K2h``
(``utils/tracing.py``).
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.ops import _cuda
from unidepth_tpu_torch.ops.fused_block import ln_dense_plain
from unidepth_tpu_torch.utils import tracing

__all__ = ["fits", "head_mlp", "head_mlp_plain"]

CHANNELS = (64, 128)  # ViT-S/14's heads; ViT-L/14's and ViT-g/14's
TILE_PIXELS = 64  # a work tile: 64 pixels of one image


def fits(c: int, h: int, w: int) -> bool:
    """Whether the kernel takes latents of C channels on an H x W grid."""
    return c in CHANNELS and (h * w) % TILE_PIXELS == 0


def head_mlp_plain(x, weights, biases, gammas, betas, eps):
    """Each head's ``ln_dense_plain`` (no activation) on the NHWC view of
    the NCHW ``x``: LayerNorm in fp32, rounded to the weight's dtype, the
    product, the bias in fp32, the result in x's dtype."""
    y = x.permute(0, 2, 3, 1)
    return tuple(ln_dense_plain(y, *head, e) for *head, e in zip(weights, biases, gammas, betas, eps))


def head_mlp(x, weights, biases, gammas, betas, eps):
    """x (B, C, H, W); per head (1 or 2): weight (C, C) in nn.Linear layout,
    bias, gamma, beta (C,) and the LayerNorm's eps -> a tuple of (B, H, W, C)
    maps in x's dtype, one a head."""
    if x.device.type == "cpu":
        return head_mlp_plain(x, weights, biases, gammas, betas, eps)
    _cuda.require_cuda("head_mlp", x, *weights, *biases, *gammas, *betas)
    return _launch(x, weights, biases, gammas, betas, eps)


def _launch(x, weights, biases, gammas, betas, eps):
    """K2h's launch, on whatever device ``x`` is (the CPU tests call it with
    the library stubbed to see the route)."""
    heads = len(weights)
    b, c, h, w = x.shape
    params = (*weights, *biases, *gammas, *betas)
    if not 1 <= heads <= 2 or not len(biases) == len(gammas) == len(betas) == len(eps) == heads:
        raise ValueError(f"head_mlp: 1 or 2 heads, each with a weight, bias, gamma, beta and eps; got {heads} weights")
    if any(t.dtype != torch.bfloat16 for t in (x, *params)):
        raise ValueError("head_mlp: x and every parameter must be bf16")
    if not fits(c, h, w):
        raise ValueError(f"head_mlp: needs C in {CHANNELS} and H * W % {TILE_PIXELS} == 0, got {tuple(x.shape)}")
    if any(t.shape != (c, c) for t in weights) or any(t.shape != (c,) for t in (*biases, *gammas, *betas)):
        raise ValueError(f"head_mlp: weights must be ({c}, {c}) and vectors ({c},)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise ValueError("head_mlp: forward only; a call that needs a gradient takes the modules")
    x = x.contiguous()  # NCHW: the pyramid's output as it lies
    params = [t.contiguous() for t in params]
    # TMA reads x, W and the outputs from 16-byte aligned bases; a misaligned
    # one would fault on the card and poison the CUDA context
    if any(t.data_ptr() % 16 for t in (x, *params)):
        raise ValueError("head_mlp: x and every parameter must start on a 16-byte boundary")
    outs = tuple(torch.empty((b, h, w, c), dtype=x.dtype, device=x.device) for _ in range(heads))

    def two(ts):  # head 1's pointer, None for one head
        return [t.data_ptr() for t in ts] + [None] * (2 - heads)

    ws, bs, gs, bts = (params[i * heads:(i + 1) * heads] for i in range(4))
    eps2 = [float(e) for e in eps] + [0.0] * (2 - heads)
    with tracing.span("unidepth.kernel.K2h"):
        err = _cuda.library().ud_head_mlp_hopper_fwd(
            x.data_ptr(), *two(ws), *two(bs), *two(gs), *two(bts), *two(outs), b, c, h * w, heads, *eps2,
            _cuda.stream_handle(x))
    _cuda.check(err, "head_mlp")
    head_mlp.launches += 1
    return outs


head_mlp.launches = 0

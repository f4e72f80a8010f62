"""DINOv2 ViT encoder (counterpart of unidepth_tpu/models/backbones/dinov2.py).

``DinoViT`` takes channel-last images (B, H, W, 3) and returns, per entry of
``output_idx``, a (B, h, w, C) feature map and a (B, 1, C) cls token:

* ``stacking='last'`` (V2): the features and cls token of each stage's last
  block, after the final norm (``use_norm``);
* ``'max'``, ``'mean'``, ``'first'``, ``'softmax'``: every block output of
  a stage, each after the final norm, reduced over the stage's blocks by
  ``utils.misc.STACKING_FNS``; the cls token is the reduction's token 0;
* ``stacking='max_cls'`` (V1): each stage's elementwise max over its blocks
  of patches + that block's cls token (a running max: no block's output is
  kept), and the cls tokens of the last ``len(output_idx)`` blocks in
  natural order.

``ViTConfig.num_register_tokens`` R > 0 adds ``register_tokens`` (1, R, C):
the tokens run as ``[cls, registers, patches]``, the registers without a
position embedding, and every feature map skips them (``1 + R:``).
``ViTConfig.interpolate_offset`` (V1 builds its encoder with 0.1) resizes
the position embedding with torch's explicit ``scale_factor`` semantics,
(grid + offset) / pos_embed_size.

``ViTBlock`` splits the JAX rule ``_use_fused`` (int8 GEMMs and a SwiGLU
MLP turn fusion off) in two: int8 alone decides the attention, and the MLP
goes by its kind and by what the block observes.

* attention: fp32 LN1 cast to the compute dtype -> qkv (a GEMM); then, in
  every block that is not int8 (SwiGLU too), kernel K1 reading the raw
  (B, N, 3C) projection with the softmax scale applied inside the kernel;
  in an int8 block (``DinoViT.quantize``) kernel K4 on the three channel
  slices of the projection, read in place. Then proj.
* GELU MLP: LN2 -> fc1 -> GELU is kernel K2, fc2 a GEMM; int8 blocks run
  fp32 LN2 cast -> fc1 -> exact GELU -> fc2 as int8 linears.
* SwiGLU MLP (``ffn_layer='swiglu'``, DINOv2 ViT-g/14): where
  ``_mlp_on_k2g`` holds (kernels on, a CUDA bf16 block that is not int8
  and needs no gradient, widths within K2's Hopper body), LN2 -> w12 ->
  ``silu(a) * g`` over the two halves of the product is one launch of K2's
  gated body, then w3 a GEMM: the (M, 2H) product never reaches device
  memory. Everywhere else (the CPU, fp32, int8, training,
  ``set_kernels(False)`` and so the exporter) the modules: fp32 LN2 cast ->
  ``w3(silu(a) * g)`` with ``(a, g)`` the halves of ``w12``.

LayerScale and the residuals stay plain.

On CPU tensors the kernels' plain versions run; ``use_kernels=False`` pins
the plain versions on any device. Every LayerNorm here uses eps 1e-6
(DINOv2 builds all its norms so).

Under autograd (training) each block runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are recomputed
in the backward, the counterpart of the JAX ``nn.remat`` blocks, so K1 and
K2 launch twice a block per micro-batch. ``forward(image, generator)`` with
``drop_path_rate > 0`` applies stochastic depth at the JAX ramp
``linspace(0, rate, depth)``: two per-sample keep masks a block (one a
residual branch), drawn from ``generator`` before the block runs, so the
recompute sees the same draw; over several processes each draws the
whole batch's masks and takes its rows (``nn.layers.BatchRows``).

Under tensor parallelism (``parallel/tp.py``) ``num_heads`` is the rank's
share of the heads and qkv, proj, fc1 and fc2 hold its slices; the block
takes its widths from ``num_heads`` and ``head_dim``, never from x (which
stays full width), and K2 takes its input and LN2's parameters through
``copy_to_tp``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from unidepth_tpu_torch.models import stage_graphs
from unidepth_tpu_torch.nn.layers import LayerScale, drop_path, layer_norm, uniform_rows
from unidepth_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_plain,
    flash_attention_qkv,
    flash_attention_qkv_plain,
)
from unidepth_tpu_torch.ops.fused_block import fits_hopper_body, ln_dense, ln_dense_plain
from unidepth_tpu_torch.ops.quant import QuantLinear, quantize_linear_tree
from unidepth_tpu_torch.ops.resize import resize
from unidepth_tpu_torch.parallel.mesh import tp_inputs
from unidepth_tpu_torch.utils.misc import STACKING_FNS


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    embed_dim: int
    depth: int
    num_heads: int
    patch_size: int = 14
    mlp_ratio: float = 4.0
    pos_embed_size: int = 37  # 518 // 14 grid, matches released checkpoints
    num_register_tokens: int = 0
    init_values: float = 1.0  # LayerScale
    ffn_layer: str = "mlp"  # "mlp" | "swiglu"
    output_idx: tuple[int, ...] = (5, 12, 18, 24)
    use_norm: bool = True
    interpolate_offset: float = 0.0  # V1: 0.1, scale_factor semantics for the pos-embed resize
    drop_path_rate: float = 0.0  # stochastic depth at train time, a linear per-block ramp

    @property
    def num_patches(self) -> int:
        return self.pos_embed_size * self.pos_embed_size


VIT_PRESETS: dict[str, ViTConfig] = {
    "vits14": ViTConfig(embed_dim=384, depth=12, num_heads=6, output_idx=(3, 6, 9, 12)),
    "vitb14": ViTConfig(embed_dim=768, depth=12, num_heads=12, output_idx=(3, 6, 9, 12)),
    "vitl14": ViTConfig(embed_dim=1024, depth=24, num_heads=16, output_idx=(6, 12, 18, 24)),
    # DINOv2 ViT-g/14 (arXiv:2304.07193): SwiGLU of hidden 4096; the outputs
    # at its quarter points, as ViT-L's (no UniDepth checkpoint ships one)
    "vitg14": ViTConfig(embed_dim=1536, depth=40, num_heads=24, mlp_ratio=4.0, ffn_layer="swiglu",
                        output_idx=(10, 20, 30, 40)),
}


class _Attention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, y):
        return self.fc2(F.gelu(self.fc1(y)))


class _SwiGLU(nn.Module):
    """DINOv2's SwiGLU FFN: its hidden width is 2/3 of the MLP's, rounded
    up to a multiple of 8."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        hidden = (hidden * 2 // 3 + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, y):
        a, g = self.w12(y).chunk(2, dim=-1)
        return self.w3(F.silu(a) * g)


class ViTBlock(nn.Module):
    """Pre-LN transformer block with LayerScale, on (B, N, C) tokens."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, init_values: float = 1.0,
                 ffn_layer: str = "mlp"):
        super().__init__()
        if ffn_layer not in ("mlp", "swiglu"):
            raise ValueError(f"ffn_layer {ffn_layer!r}: 'mlp' or 'swiglu'")
        self.num_heads = num_heads  # this rank's heads under tensor parallelism (parallel/tp.py)
        self.head_dim = dim // num_heads
        self.use_kernels = True
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim)
        self.ls1 = LayerScale(dim, init_values) if init_values else None
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = (_Mlp if ffn_layer == "mlp" else _SwiGLU)(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values) if init_values else None

    @property
    def quant(self) -> bool:
        """int8 GEMMs: the block's linears are QuantLinears (``DinoViT.quantize``)."""
        return isinstance(self.attn.qkv, QuantLinear)

    def _mlp_on_k2g(self, x: torch.Tensor) -> bool:
        """Whether the SwiGLU MLP's LN2 -> w12 -> ``silu(a) * g`` runs as K2's
        gated launch on ``x``: kernels on, a block that is not int8, a CUDA
        bf16 ``x`` where nothing needs a gradient, and widths K2's Hopper
        body takes (``fits_hopper_body``)."""
        mlp, n2 = self.mlp, self.norm2
        if not (self.use_kernels and isinstance(mlp, _SwiGLU) and not self.quant):
            return False
        w12 = mlp.w12
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, n2.weight, n2.bias, w12.weight, w12.bias))
        return (x.is_cuda and x.dtype == w12.weight.dtype and not needs_grad
                and fits_hopper_body(w12.in_features, w12.out_features, x.dtype))

    def forward(self, x, keep_masks=None, keep: float = 1.0):
        """``keep_masks``: None, or (2, B) bools, the stochastic-depth draw
        of the attention and MLP branches at keep probability ``keep``."""
        # under tensor parallelism x is full width and qkv holds this rank's
        # heads: the widths come from the heads, never from x
        c = self.num_heads * self.head_dim
        scale = self.head_dim**-0.5
        # int8 GEMMs turn the QKV-direct attention and K2 off (the JAX rule
        # _use_fused, dinov2.py:113-135); a SwiGLU MLP keeps K1 and takes
        # K2's gated body where _mlp_on_k2g holds
        quant = self.quant
        qkv = self.attn.qkv(layer_norm(self.norm1, x))
        if not quant:
            attn_fn = flash_attention_qkv if self.use_kernels else flash_attention_qkv_plain
            attn = attn_fn(qkv, self.num_heads, scale)
        else:
            attn_fn = flash_attention_packed if self.use_kernels else flash_attention_packed_plain
            attn = attn_fn(qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :], self.num_heads, scale)
        attn = self.attn.proj(attn)
        if self.ls1 is not None:
            attn = self.ls1(attn)
        if keep_masks is not None:
            attn = drop_path(attn, keep_masks[0], keep)
        x = x + attn
        n2 = self.norm2
        if not quant and isinstance(self.mlp, _Mlp):
            fc1 = self.mlp.fc1
            ln_dense_fn = ln_dense if self.use_kernels else ln_dense_plain
            xt, gamma, beta = tp_inputs(fc1, x, n2.weight, n2.bias)
            y = self.mlp.fc2(ln_dense_fn(xt, fc1.weight, fc1.bias, gamma, beta, n2.eps, "gelu"))
        elif self._mlp_on_k2g(x):
            w12 = self.mlp.w12
            y = self.mlp.w3(ln_dense(x, w12.weight, w12.bias, n2.weight, n2.bias, n2.eps, "swiglu"))
        else:
            y = self.mlp(layer_norm(n2, x))
        if self.ls2 is not None:
            y = self.ls2(y)
        if keep_masks is not None:
            y = drop_path(y, keep_masks[1], keep)
        return x + y


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch, stride=patch)


class DinoViT(nn.Module):
    """DINOv2 encoder producing per-stage features and cls tokens."""

    def __init__(self, cfg: ViTConfig, stacking: str = "last"):
        super().__init__()
        if stacking not in (*STACKING_FNS, "max_cls"):
            raise ValueError(f"stacking {stacking!r}: one of {(*STACKING_FNS, 'max_cls')}")
        self.cfg = cfg
        self.stacking = stacking
        c = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg.patch_size, c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, c))
        if cfg.num_register_tokens:
            self.register_tokens = nn.Parameter(torch.zeros(1, cfg.num_register_tokens, c))
        self.blocks = nn.ModuleList(
            [ViTBlock(c, cfg.num_heads, cfg.mlp_ratio, cfg.init_values, cfg.ffn_layer) for _ in range(cfg.depth)]
        )
        self.norm = nn.LayerNorm(c, eps=1e-6) if cfg.use_norm else None

    def quantize(self, quant: bool | tuple = True, weights: dict | None = None) -> "DinoViT":
        """An int8 copy of this encoder, the JAX ``DinoViT(quant=...)``:
        ``quant`` is one bool for every block or a per-stage tuple over
        ``output_idx``. The qkv/proj/fc1/fc2 (SwiGLU: w12/w3) linears of the
        selected stages become QuantLinears quantized from ``weights``
        (qualified name -> fp32 (weight, bias), the masters) and their blocks
        run unfused; every other module and parameter is shared with this
        encoder."""
        n = len(self.cfg.output_idx)
        mask = (quant,) * n if isinstance(quant, bool) else tuple(bool(q) for q in quant)
        if len(mask) != n:
            raise ValueError(f"quant mask {quant!r} has {len(mask)} entries, the encoder {n} stages")
        bounds = [0, *self.cfg.output_idx]
        prefixes = tuple(
            f"blocks.{i}." for si, on in enumerate(mask) if on for i in range(bounds[si], bounds[si + 1])
        )
        return quantize_linear_tree(self, prefixes=prefixes, weights=weights) if prefixes else self

    def _blocks(self, x, generator):
        """Yield each block's output in turn: checkpointed under autograd,
        with the stochastic-depth draw when ``generator`` is given and the
        rate is positive."""
        rates = np.linspace(0.0, self.cfg.drop_path_rate, self.cfg.depth)
        use_dp = generator is not None and self.cfg.drop_path_rate > 0.0
        for block, rate in zip(self.blocks, rates):
            keep, masks = 1.0 - float(rate), None
            if use_dp and rate > 0.0:
                masks = (uniform_rows(generator, (2,), x.shape[0]) < keep).to(x.device)
            if torch.is_grad_enabled():
                # the masks are inputs, so no RNG state needs restoring
                x = checkpoint(block, x, masks, keep, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, masks, keep)
            yield x

    def forward(self, image: torch.Tensor, generator: torch.Generator | None = None):
        """image: (B, H, W, 3), H and W multiples of the patch size.
        ``generator`` turns stochastic depth on (training) when the
        config's ``drop_path_rate`` is positive. Inside V2's ``infer()`` a
        CUDA graph of this body may run instead (``models/stage_graphs.py``)."""
        return stage_graphs.call(self, self._forward, image, generator)

    def _forward(self, image: torch.Tensor, generator: torch.Generator | None):
        cfg = self.cfg
        b, h, w, _ = image.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        c = cfg.embed_dim
        x = self.patch_embed.proj(image.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)

        pos = self.pos_embed
        patch_pos = pos[:, 1:].reshape(1, cfg.pos_embed_size, cfg.pos_embed_size, c)
        if (gh, gw) != (cfg.pos_embed_size, cfg.pos_embed_size):
            # bicubic, antialias off, sized to the patch grid; with an
            # offset, torch's scale_factor semantics (the source grid at
            # pos_embed_size / (grid + offset))
            off = cfg.interpolate_offset
            scales = ((gh + off) / cfg.pos_embed_size, (gw + off) / cfg.pos_embed_size) if off else None
            patch_pos = resize(patch_pos, (gh, gw), mode="bicubic", align_corners=False, scale_factors=scales)
        x = x + patch_pos.reshape(1, gh * gw, c).to(x.dtype)
        cls = (self.cls_token + pos[:, :1]).expand(b, 1, c).to(x.dtype)
        reg = cfg.num_register_tokens
        registers = [self.register_tokens.expand(b, reg, c).to(x.dtype)] if reg else []
        x = torch.cat([cls, *registers, x], dim=1)

        feats, cls_tokens = [], []
        ends = set(cfg.output_idx)
        if self.stacking == "max_cls":
            last = cfg.output_idx[-1]
            stage_max = None
            for i, x in zip(range(last), self._blocks(x, generator)):
                y = x[:, 1 + reg :] + x[:, :1]
                stage_max = y if stage_max is None else torch.maximum(stage_max, y)
                if i >= last - len(cfg.output_idx):
                    cls_tokens.append(x[:, :1])
                if i + 1 in ends:
                    feats.append(stage_max.reshape(b, gh, gw, c))
                    stage_max = None
            return feats, cls_tokens
        stage = []
        for i, x in enumerate(self._blocks(x, generator)):
            if self.stacking != "last" or i + 1 in ends:
                stage.append(layer_norm(self.norm, x) if self.norm is not None else x)
            if i + 1 in ends:
                out = STACKING_FNS[self.stacking](stage)
                cls_tokens.append(out[:, :1])
                feats.append(out[:, 1 + reg :].reshape(b, gh, gw, c))
                stage = []
        return feats, cls_tokens

"""DINOv2 ViT encoder (counterpart of unidepth_tpu/models/backbones/dinov2.py).

``DinoViT`` takes channel-last images (B, H, W, 3) and returns, per entry of
``output_idx``, a (B, h, w, C) feature map and a (B, 1, C) cls token:

* ``stacking='last'`` (V2): the features and cls token of each stage's last
  block;
* ``stacking='max_cls'`` (V1): each stage's elementwise max over its blocks
  of patches + that block's cls token (a running max: no block's output is
  kept), and the cls tokens of the last ``len(output_idx)`` blocks in
  natural order.

``ViTConfig.interpolate_offset`` (V1 builds its encoder with 0.1) resizes
the position embedding with torch's explicit ``scale_factor`` semantics,
(grid + offset) / pos_embed_size. Register tokens, SwiGLU and the other
stacking modes are not ported yet.

``ViTBlock`` has the JAX block's two branches, chosen by the JAX rule
``_use_fused``: int8 GEMMs turn fusion off.

* fused (bf16 serving): LN1 -> qkv stays plain (``F.layer_norm`` + a GEMM);
  attention is kernel K1 reading the raw (B, N, 3C) projection with the
  softmax scale applied inside the kernel; LN2 -> fc1 -> GELU is kernel K2;
  fc2, LayerScale and the residuals stay plain.
* unfused (int8 serving, ``DinoViT.quantize``): fp32 LN1 cast to the compute
  dtype -> int8 qkv -> kernel K4 on the three channel slices of the
  projection, read in place -> int8 proj; fp32 LN2 cast -> int8 fc1 ->
  exact GELU -> int8 fc2.

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
recompute sees the same draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from unidepth_tpu_torch.nn.layers import LayerScale, drop_path, layer_norm
from unidepth_tpu_torch.ops.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_plain,
    flash_attention_qkv,
    flash_attention_qkv_plain,
)
from unidepth_tpu_torch.ops.fused_block import ln_dense, ln_dense_plain
from unidepth_tpu_torch.ops.quant import QuantLinear, quantize_linear_tree
from unidepth_tpu_torch.ops.resize import resize


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


class ViTBlock(nn.Module):
    """Pre-LN transformer block with LayerScale, on (B, N, C) tokens."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, init_values: float = 1.0):
        super().__init__()
        self.num_heads = num_heads
        self.use_kernels = True
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim)
        self.ls1 = LayerScale(dim, init_values) if init_values else None
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim, init_values) if init_values else None

    @property
    def quant(self) -> bool:
        """int8 GEMMs: the block's linears are QuantLinears (``DinoViT.quantize``)."""
        return isinstance(self.attn.qkv, QuantLinear)

    def forward(self, x, keep_masks=None, keep: float = 1.0):
        """``keep_masks``: None, or (2, B) bools, the stochastic-depth draw
        of the attention and MLP branches at keep probability ``keep``."""
        c = x.shape[-1]
        scale = (c // self.num_heads) ** -0.5
        # the JAX rule _use_fused (dinov2.py:113-135): int8 GEMMs turn the
        # fused LN -> GEMM and QKV-direct attention kernels off
        fused = not self.quant
        qkv = self.attn.qkv(layer_norm(self.norm1, x))
        if fused:
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
        n2, fc1 = self.norm2, self.mlp.fc1
        if fused:
            ln_dense_fn = ln_dense if self.use_kernels else ln_dense_plain
            y = ln_dense_fn(x, fc1.weight, fc1.bias, n2.weight, n2.bias, n2.eps, "gelu")
        else:
            y = F.gelu(fc1(layer_norm(n2, x)))
        y = self.mlp.fc2(y)
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
        if stacking not in ("last", "max_cls"):
            raise NotImplementedError(f"stacking {stacking!r}: only 'last' and 'max_cls' are ported")
        if cfg.num_register_tokens:
            raise NotImplementedError("register tokens are not ported")
        self.cfg = cfg
        self.stacking = stacking
        c = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg.patch_size, c)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, c))
        self.blocks = nn.ModuleList(
            [ViTBlock(c, cfg.num_heads, cfg.mlp_ratio, cfg.init_values) for _ in range(cfg.depth)]
        )
        self.norm = nn.LayerNorm(c, eps=1e-6) if cfg.use_norm else None

    def quantize(self, quant: bool | tuple = True, weights: dict | None = None) -> "DinoViT":
        """An int8 copy of this encoder, the JAX ``DinoViT(quant=...)``:
        ``quant`` is one bool for every block or a per-stage tuple over
        ``output_idx``. The qkv/proj/fc1/fc2 linears of the selected stages
        become QuantLinears quantized from ``weights`` (qualified name ->
        fp32 (weight, bias), the masters) and their blocks run unfused; every
        other module and parameter is shared with this encoder."""
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
                u = torch.rand((2, x.shape[0]), generator=generator, device=generator.device)
                masks = (u < keep).to(x.device)
            if torch.is_grad_enabled():
                # the masks are inputs, so no RNG state needs restoring
                x = checkpoint(block, x, masks, keep, use_reentrant=False, preserve_rng_state=False)
            else:
                x = block(x, masks, keep)
            yield x

    def forward(self, image: torch.Tensor, generator: torch.Generator | None = None):
        """image: (B, H, W, 3), H and W multiples of the patch size.
        ``generator`` turns stochastic depth on (training) when the
        config's ``drop_path_rate`` is positive."""
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
        x = torch.cat([cls, x], dim=1)

        feats, cls_tokens = [], []
        ends = set(cfg.output_idx)
        if self.stacking == "max_cls":
            last = cfg.output_idx[-1]
            stage_max = None
            for i, x in zip(range(last), self._blocks(x, generator)):
                y = x[:, 1:] + x[:, :1]
                stage_max = y if stage_max is None else torch.maximum(stage_max, y)
                if i >= last - len(cfg.output_idx):
                    cls_tokens.append(x[:, :1])
                if i + 1 in ends:
                    feats.append(stage_max.reshape(b, gh, gw, c))
                    stage_max = None
            return feats, cls_tokens
        for i, x in enumerate(self._blocks(x, generator)):
            if i + 1 in ends:
                out = layer_norm(self.norm, x) if self.norm is not None else x
                cls_tokens.append(out[:, :1])
                feats.append(out[:, 1:].reshape(b, gh, gw, c))
        return feats, cls_tokens

"""DINOv2 ViT encoder (counterpart of unidepth_tpu/models/backbones/dinov2.py).

``DinoViT`` takes channel-last images (B, H, W, 3) and returns, per entry of
``output_idx``, a (B, h, w, C) feature map and a (B, 1, C) cls token, with
``stacking='last'`` (the features of each stage's last block). Register
tokens, SwiGLU and the other stacking modes are not ported yet.

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
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidepth_tpu_torch.nn.layers import LayerScale, layer_norm
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

    def forward(self, x):
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
        return x + y


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch, stride=patch)


class DinoViT(nn.Module):
    """DINOv2 encoder producing per-stage features and cls tokens."""

    def __init__(self, cfg: ViTConfig, stacking: str = "last"):
        super().__init__()
        if stacking != "last":
            raise NotImplementedError(f"stacking {stacking!r}: only 'last' is ported")
        if cfg.num_register_tokens:
            raise NotImplementedError("register tokens are not ported")
        self.cfg = cfg
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

    def forward(self, image: torch.Tensor):
        """image: (B, H, W, 3), H and W multiples of the patch size."""
        cfg = self.cfg
        b, h, w, _ = image.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        c = cfg.embed_dim
        x = self.patch_embed.proj(image.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)

        pos = self.pos_embed
        patch_pos = pos[:, 1:].reshape(1, cfg.pos_embed_size, cfg.pos_embed_size, c)
        # bicubic, antialias off, sized to the patch grid (V2 builds its
        # encoder with interpolate_offset 0: no scale_factor semantics)
        patch_pos = resize(patch_pos, (gh, gw), mode="bicubic", align_corners=False)
        x = x + patch_pos.reshape(1, gh * gw, c).to(x.dtype)
        cls = (self.cls_token + pos[:, :1]).expand(b, 1, c).to(x.dtype)
        x = torch.cat([cls, x], dim=1)

        feats, cls_tokens = [], []
        ends = set(cfg.output_idx)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i + 1 in ends:
                out = layer_norm(self.norm, x) if self.norm is not None else x
                cls_tokens.append(out[:, :1])
                feats.append(out[:, 1:].reshape(b, gh, gw, c))
        return feats, cls_tokens

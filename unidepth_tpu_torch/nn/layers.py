"""Core layers (counterpart of unidepth_tpu/nn/layers.py).

Pre-LN (cross-)attention with additive per-head positional embeddings on q
and k, LayerScale residuals, and an LN -> Linear -> GELU -> Linear MLP.
Tokens are (B, N, C). LayerNorm statistics run in fp32 and the result is
cast to the module's compute dtype (its weights' dtype); products run in
that dtype. Every LayerNorm here uses eps 1e-5. Submodule names are the
reference checkpoint's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidepth_tpu_torch.ops.attention import attention, sdpa
from unidepth_tpu_torch.ops.fused_block import ln_dense, ln_dense_plain


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``norm`` applied in fp32, cast to the norm's parameter dtype."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps)
    return y.to(norm.weight.dtype)


def ln_linear_gelu(norm: nn.LayerNorm, linear: nn.Linear, x: torch.Tensor, use_kernels: bool = True) -> torch.Tensor:
    """``GELU(linear(norm(x)))`` on channel-last ``x``: kernel K2
    (``ops.fused_block.ln_dense``) where its shape gate holds (C % 32 == 0
    and F % 128 == 0), else its plain version, the same function. The choice
    is made by shape, before the call: the JAX package fuses wherever
    ``ln_dense_supported`` holds (C % 16, F % 128), which K2 does not
    cover."""
    fits = linear.in_features % 32 == 0 and linear.out_features % 128 == 0
    fn = ln_dense if use_kernels and fits else ln_dense_plain
    return fn(x, linear.weight, linear.bias, norm.weight, norm.bias, norm.eps, "gelu")


def drop_path(x: torch.Tensor, keep_mask: torch.Tensor, keep: float) -> torch.Tensor:
    """Stochastic depth over the batch axis (the JAX ``drop_path``): samples
    whose ``keep_mask`` entry is False lose the branch, the others are
    scaled by 1 / ``keep``."""
    mask = keep_mask.reshape(-1, *(1,) * (x.ndim - 1))
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class LayerScale(nn.Module):
    """Per-channel learned residual scale."""

    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.init_value = float(init_value)
        self.gamma = nn.Parameter(torch.full((dim,), self.init_value))

    def forward(self, x):
        return x * self.gamma


class MLP(nn.Module):
    """LN -> Linear -> exact GELU -> Linear."""

    def __init__(self, dim: int, expansion: int = 4, output_dim: int | None = None):
        super().__init__()
        hidden = int(dim * expansion)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.proj1 = nn.Linear(dim, hidden)
        self.proj2 = nn.Linear(hidden, output_dim if output_dim is not None else dim)

    def forward(self, x):
        return self.proj2(F.gelu(self.proj1(layer_norm(self.norm, x))))


class AttentionBlock(nn.Module):
    """Pre-LN (cross-)attention block: queries from ``x``, keys and values
    from ``context`` (x itself by default); ``pos_embed`` /
    ``pos_embed_context`` are added to q / k per head. ``use_kernels=False``
    pins the plain attention."""

    def __init__(
        self,
        dim: int,
        num_heads: int = 4,
        expansion: int = 4,
        layer_scale: float = 1.0,
        context_dim: int | None = None,
        use_bias: bool = True,
    ):
        super().__init__()
        context_dim = dim if context_dim is None else context_dim
        self.num_heads = num_heads
        self.use_kernels = True
        self.norm_attnx = nn.LayerNorm(dim, eps=1e-5)
        self.norm_attnctx = nn.LayerNorm(context_dim, eps=1e-5)
        self.kv = nn.Linear(context_dim, 2 * dim, bias=use_bias)
        self.q = nn.Linear(dim, dim, bias=use_bias)
        self.out = nn.Linear(dim, dim, bias=use_bias)
        self.mlp = MLP(dim, expansion=expansion)
        self.ls1 = LayerScale(dim, layer_scale) if layer_scale > 0.0 else None
        self.ls2 = LayerScale(dim, layer_scale) if layer_scale > 0.0 else None

    def _attend(self, q, k, v):
        return attention(q, k, v) if self.use_kernels else sdpa(q, k, v)

    def forward(self, x, context=None, pos_embed=None, pos_embed_context=None):
        context = x if context is None else context
        y = layer_norm(self.norm_attnx, x)
        ctx = layer_norm(self.norm_attnctx, context)
        # reference layout "b n (kv h d)": k is the first half, v the second
        k, v = self.kv(ctx).chunk(2, dim=-1)
        q = split_heads(self.q(y), self.num_heads)
        k = split_heads(k, self.num_heads)
        v = split_heads(v, self.num_heads)
        if pos_embed is not None:
            q = q + split_heads(pos_embed.to(q.dtype), self.num_heads)
        if pos_embed_context is not None:
            k = k + split_heads(pos_embed_context.to(k.dtype), self.num_heads)
        attn = self.out(merge_heads(self._attend(q, k, v)))
        if self.ls1 is not None:
            attn = self.ls1(attn)
        x = x + attn
        mlp = self.mlp(x)
        if self.ls2 is not None:
            mlp = self.ls2(mlp)
        return x + mlp


class AttentionLayer(nn.Module):
    """A stack of AttentionBlocks sharing context and positional embeddings."""

    def __init__(self, num_blocks: int, dim: int, **block_kwargs):
        super().__init__()
        self.layers = nn.ModuleList([AttentionBlock(dim, **block_kwargs) for _ in range(num_blocks)])

    def forward(self, x, context=None, pos_embed=None, pos_embed_context=None):
        for layer in self.layers:
            x = layer(x, context=context, pos_embed=pos_embed, pos_embed_context=pos_embed_context)
        return x

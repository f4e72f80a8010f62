"""The plain operations the benchmark's references are written in.

Every product of the references (linear layers, convolutions, attention,
the Nystrom matmuls) goes through a ``Numerics`` object, which does two
things the references' callers ask for:

* ``fp8=True`` computes every product in float8 e4m3: both operands and the
  result are rounded to it, each with a per-tensor scale (the tensor's
  largest magnitude maps to 448), the product itself in float32. That is
  the control of the correctness check: the reference one precision step
  below the bf16 the configurations state.
* ``tally`` (a ``Tally``) counts the work of every product as the algorithm
  needs it at the shapes it sees: 2 M K N for a linear layer, 2 B Cout Hout
  Wout Cin/groups kh kw for a convolution, 4 B H Nq Nk D for an attention,
  and the bytes each attention and each LN -> Linear -> GELU reads once and
  writes once. Run on the ``meta`` device it counts without computing.

Everything runs in float32 (TF32 is the caller's to switch off). This file
imports torch only.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn value
BF16_BYTES = 2  # the served dtype, for the byte counts


@dataclasses.dataclass
class Tally:
    """Work counted while a reference runs (see the module docstring)."""

    flops: float = 0.0
    attention_flops: float = 0.0
    attention_bytes: float = 0.0
    attention_calls: int = 0
    ln_dense_flops: float = 0.0
    ln_dense_bytes: float = 0.0
    ln_dense_calls: int = 0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3fn with a per-tensor scale, back in float32."""
    amax = t.detach().abs().amax().clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (t / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float() * scale


class Numerics:
    """The products of a reference, in float32 or as the fp8 control."""

    def __init__(self, fp8: bool = False, tally: Tally | None = None):
        self.fp8 = fp8
        self.tally = tally

    def _q(self, t):
        return fp8_round(t) if self.fp8 else t

    def _count(self, flops: float) -> None:
        if self.tally is not None:
            self.tally.flops += flops

    def linear(self, x, weight, bias=None):
        m = x.numel() // x.shape[-1]
        self._count(2.0 * m * weight.shape[0] * weight.shape[1])
        return self._q(F.linear(self._q(x), self._q(weight), bias))

    def ln_linear_gelu(self, x, norm_w, norm_b, eps, weight, bias):
        """GELU(linear(LayerNorm(x))): the block the kernel K2 fuses, counted
        apart as well."""
        y = F.layer_norm(x, x.shape[-1:], norm_w, norm_b, eps)
        if self.tally is not None:
            m, c, f = x.numel() // x.shape[-1], weight.shape[1], weight.shape[0]
            self.tally.ln_dense_flops += 2.0 * m * c * f
            self.tally.ln_dense_bytes += BF16_BYTES * (m * c + f * c + f + 2 * c + m * f)
            self.tally.ln_dense_calls += 1
        return F.gelu(self.linear(y, weight, bias))

    def conv2d(self, x, weight, bias=None, stride=1, padding=0, groups=1, padding_mode="zeros"):
        """NCHW convolution; ``padding_mode`` 'reflect' pads by ``padding``
        first."""
        if padding_mode == "reflect" and padding:
            x = F.pad(x, (padding,) * 4, mode="reflect")
            padding = 0
        out = F.conv2d(self._q(x), self._q(weight), bias, stride=stride, padding=padding, groups=groups)
        b, cout, ho, wo = out.shape
        self._count(2.0 * b * cout * ho * wo * weight.shape[1] * weight.shape[2] * weight.shape[3])
        return self._q(out)

    def conv_transpose_patch(self, x, weight, bias):
        """ConvTranspose2d with kernel == stride: every input pixel becomes an
        independent output patch."""
        b, cin, h, w = x.shape
        s = weight.shape[-1]
        self._count(2.0 * b * h * w * cin * weight.shape[1] * s * s)
        return self._q(F.conv_transpose2d(self._q(x), self._q(weight), bias, stride=s))

    def matmul(self, a, b):
        out = torch.matmul(self._q(a), self._q(b))
        self._count(2.0 * out.numel() * a.shape[-1])
        return self._q(out)

    def attention(self, q, k, v, scale: float | None = None):
        """softmax(scale q k^T) v over (B, H, N, D), scores and softmax in
        float32."""
        b, h, nq, d = q.shape
        nk = k.shape[2]
        if self.tally is not None:
            self.tally.attention_flops += 4.0 * b * h * nq * nk * d
            self.tally.attention_bytes += BF16_BYTES * b * h * d * (2 * nq + 2 * nk)
            self.tally.attention_calls += 1
        self._count(4.0 * b * h * nq * nk * d)
        scale = d**-0.5 if scale is None else scale
        w = torch.softmax(torch.matmul(self._q(q), self._q(k).transpose(-1, -2)) * scale, dim=-1)
        return self._q(torch.matmul(self._q(w), self._q(v)))


def layer_norm(x, weight, bias, eps):
    return F.layer_norm(x, x.shape[-1:], weight, bias, eps)


def split_heads(x, heads):
    b, n, c = x.shape
    return x.reshape(b, n, heads, c // heads).transpose(1, 2)


def merge_heads(x):
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def resize(x, size, mode="bilinear", align_corners=False, antialias=False, channel_last=True):
    """``F.interpolate`` of (..., H, W, C) (or (..., H, W)) maps in float32;
    the same size returns the input."""
    y = x.movedim(-1, -3) if channel_last else x
    in_h, in_w = y.shape[-2:]
    if (in_h, in_w) == tuple(size):
        return x
    lead = y.shape[:-2]
    y = F.interpolate(y.reshape(1, -1, in_h, in_w), size=tuple(size), mode=mode, align_corners=align_corners,
                      antialias=antialias)
    y = y.reshape(*lead, *size)
    return y.movedim(-3, -1) if channel_last else y


def flat_interpolate(x, old, new, antialias=True):
    """(B, old_h * old_w, C) token grids resized to (B, new_h * new_w, C)."""
    if tuple(old) == tuple(new):
        return x
    b, _, c = x.shape
    return resize(x.reshape(b, old[0], old[1], c), new, antialias=antialias).reshape(b, new[0] * new[1], c)


def coords_grid(h, w, device):
    """(H, W, 2) pixel-centre coordinates (x, y), centres at +0.5."""
    xs = torch.arange(w, device=device, dtype=torch.float32) + 0.5
    ys = torch.arange(h, device=device, dtype=torch.float32) + 0.5
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1)


def rays_from_K(K, h, w, eps):
    """Unit rays (B, H*W, 3) through the pixel centres of K (B, 3, 3)."""
    uv = coords_grid(h, w, K.device).reshape(-1, 2)
    fx, fy, cx, cy = (K[:, i, j, None] for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    x = (uv[None, :, 0] - cx) / fx
    y = (uv[None, :, 1] - cy) / fy
    rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp_min(eps)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


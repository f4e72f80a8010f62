"""UniDepthV1 decoder (counterpart of unidepth_tpu/models/unidepthv1/decoder.py).

The camera head attends from the cls tokens to every level's tokens and
regresses a pinhole K. The depth head embeds the rays as degree-8 real
spherical harmonics at three scales, runs attention blocks at the common
grid (``layers_16``: kernel K3 through ``ops.attention``; the one-head
D = 512 blocks and the 4-latent camera blocks run plain attention, as in
JAX), Nystrom blocks at 2x and 4x, ``ConvUpsample`` stages between them,
and returns three exp-clipped log-depth maps (out8/4/2).

Tokens are (B, N, C), maps channel-last, as in the JAX package. Module
names are the reference checkpoint's.

Inside V1's ``infer()`` the decoder's forward may run as a CUDA graph
replay (``models/stage_graphs.py``), so nothing in its body makes the host
wait on the device: the sine position embedding is built once per grid and
device. Its spans: ``unidepth.decoder.camera`` (the adapters, the level and
position embeddings and the camera head) and ``unidepth.decoder.depth``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from unidepth_tpu_torch.geometry.rays import generate_rays
from unidepth_tpu_torch.models import stage_graphs
from unidepth_tpu_torch.nn.conv import Conv2d
from unidepth_tpu_torch.nn.layers import MLP, AttentionBlock, layer_norm
from unidepth_tpu_torch.nn.nystrom import NystromBlock
from unidepth_tpu_torch.nn.upsample import ConvUpsample
from unidepth_tpu_torch.ops.fourier import position_embedding_sine
from unidepth_tpu_torch.ops.resize import flat_interpolate
from unidepth_tpu_torch.ops.sht import rsh_cart_8
from unidepth_tpu_torch.utils import tracing
from unidepth_tpu_torch.utils.built_once import built_once


@built_once()
def _sine_grid(h: int, w: int, hidden: int, device: torch.device) -> torch.Tensor:
    """The normalised sine position embedding of an (h, w) grid as (h*w,
    hidden) float32 tokens on ``device``."""
    return position_embedding_sine(h, w, num_pos_feats=hidden // 2, normalize=True, device=device).reshape(h * w, hidden)


class AdapterItem(nn.Sequential):
    """LN (eps 1e-5) -> Linear -> exact GELU."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__(nn.LayerNorm(input_dim, eps=1e-5), nn.Linear(input_dim, hidden_dim), nn.GELU())

    def forward(self, x):
        return F.gelu(self[1](layer_norm(self[0], x)))


class _ListAdapter(nn.Module):
    def __init__(self, input_dims, hidden_dim: int):
        super().__init__()
        self.input_adapters = nn.ModuleList([AdapterItem(d, hidden_dim) for d in input_dims])


class CameraHeadV1(nn.Module):
    """cls tokens (B, 4, hidden) and every level's tokens -> K (B, 3, 3)."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, expansion: int = 4):
        super().__init__()
        self.cls_project = nn.Sequential(
            nn.LayerNorm(hidden_dim, eps=1e-5),
            nn.Linear(hidden_dim, hidden_dim // 2),
            nn.GELU(),
            nn.Linear(hidden_dim // 2, hidden_dim),
        )
        self.latents_pos = nn.Parameter(torch.zeros(1, 4, hidden_dim))
        self.in_features = MLP(hidden_dim, expansion=2)
        self.aggregate = AttentionBlock(hidden_dim, num_heads=1, expansion=expansion)
        self.layers = nn.ModuleList([AttentionBlock(hidden_dim, num_heads=num_heads, expansion=expansion) for _ in range(2)])
        self.out = MLP(hidden_dim, expansion=2, output_dim=1)

    def forward(self, features, cls_tokens, pos_embed, original_shapes):
        norm, fc1, _, fc2 = self.cls_project
        cls_tokens = fc2(F.gelu(fc1(layer_norm(norm, cls_tokens))))
        stack = torch.cat(features, dim=1) + pos_embed.to(cls_tokens.dtype)
        context = torch.cat([self.in_features(stack), cls_tokens], dim=1)
        pos = self.latents_pos.to(cls_tokens.dtype).expand(cls_tokens.shape[0], -1, -1)
        x = self.aggregate(cls_tokens, context=context, pos_embed=pos)
        for layer in self.layers:
            x = layer(x, pos_embed=pos)
        x = self.out(x)[..., 0].float()
        h, w = original_shapes
        half = max(original_shapes) / 2.0
        fx, fy = torch.exp(x[:, 0]) * half, torch.exp(x[:, 1]) * half
        cx, cy = torch.sigmoid(x[:, 2]) * w, torch.sigmoid(x[:, 3]) * h
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack(
            [torch.stack([fx, z, cx], -1), torch.stack([z, fy, cy], -1), torch.stack([z, z, o], -1)], dim=-2
        )


class DepthHeadV1(nn.Module):
    """Ray-conditioned multi-scale depth decoder."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, expansion: int = 4, depths: tuple[int, ...] = (3, 2, 1)):
        super().__init__()
        hd = hidden_dim
        dims = [hd, hd // 2, hd // 4]
        heads = [max(1, num_heads >> li) for li in range(3)]
        sh = 81  # degree-8 real spherical harmonics
        self.project_rays16 = MLP(sh, expansion=expansion, output_dim=hd)
        self.project_rays8 = MLP(sh, expansion=expansion, output_dim=hd // 2)
        self.project_rays4 = MLP(sh, expansion=expansion, output_dim=hd // 4)
        self.features_channel_cat = nn.Linear(4 * hd, hd)
        self.to_latents = MLP(hd, expansion=2)
        self.aggregate_16 = AttentionBlock(hd, num_heads=1, expansion=expansion, context_dim=hd)
        self.prompt_camera = AttentionBlock(hd, num_heads=1, expansion=expansion, context_dim=hd)
        self.layers_16 = nn.ModuleList(
            [AttentionBlock(hd, num_heads=heads[0], expansion=expansion) for _ in range(depths[0])]
        )
        self.layers_8 = nn.ModuleList([NystromBlock(dims[1], heads[1], expansion) for _ in range(depths[1])])
        self.layers_4 = nn.ModuleList([NystromBlock(dims[2], heads[2], expansion) for _ in range(depths[2])])
        for li, scale in enumerate((8, 4, 2)):
            setattr(self, f"up{scale}", ConvUpsample(dims[li], expansion=expansion))
            setattr(self, f"out{scale}", Conv2d(dims[li] // 2, 1, kernel_size=3))

    def _rays_embed(self, rays_hr, new_shape, original_shapes, mlp):
        r = flat_interpolate(rays_hr.float(), old=original_shapes, new=new_shape, antialias=True)
        r = r / torch.linalg.norm(r, dim=-1, keepdim=True).clamp_min(1e-12)
        return mlp(rsh_cart_8(r).to(mlp.proj1.weight.dtype))

    def forward(self, features, rays_hr, pos_embed, level_embed, shapes, original_shapes):
        b = features[0].shape[0]
        h16, w16 = shapes
        rays_hr = rays_hr.detach()  # the rays condition the depth; no gradient reaches the camera head
        emb16 = self._rays_embed(rays_hr, (h16, w16), original_shapes, self.project_rays16)
        emb8 = self._rays_embed(rays_hr, (2 * h16, 2 * w16), original_shapes, self.project_rays8)
        emb4 = self._rays_embed(rays_hr, (4 * h16, 4 * w16), original_shapes, self.project_rays4)

        tokens = torch.cat(features, dim=1)
        tokens_pos = (pos_embed + level_embed).to(tokens.dtype)
        latents = self.to_latents(self.features_channel_cat(torch.cat(features, dim=-1)))
        latents = self.aggregate_16(latents, context=tokens, pos_embed_context=tokens_pos)
        latents = self.prompt_camera(latents, context=emb16)

        outs = []
        shape = (h16, w16)
        depth_features = None
        for li, (layers, emb, scale) in enumerate(
            zip((self.layers_16, self.layers_8, self.layers_4), (emb16, emb8, emb4), (8, 4, 2))
        ):
            for layer in layers:
                latents = layer(latents, pos_embed=emb)
            if li == 0:
                depth_features = latents.reshape(b, *shape, -1)
            latents = getattr(self, f"up{scale}")((latents + emb).reshape(b, *shape, -1))
            shape = (2 * shape[0], 2 * shape[1])
            grid = latents.reshape(b, *shape, -1).permute(0, 3, 1, 2)
            out = getattr(self, f"out{scale}")(grid).permute(0, 2, 3, 1)
            outs.append(torch.exp(out.float().clamp(-10.0, 10.0)))
        return outs, depth_features


class DecoderV1(nn.Module):
    """Full V1 decoder. ``input_dims``: the encoder's per-level feature
    widths; ``token_dims``: the widths of its cls tokens in the order the
    encoder returns them (the token adapters read them reversed)."""

    def __init__(self, input_dims: tuple[int, ...], token_dims: tuple[int, ...], hidden_dim: int,
                 num_heads: int = 8, expansion: int = 4, depths: tuple[int, ...] = (3, 2, 1)):
        super().__init__()
        n = len(input_dims)
        self.input_adapter = _ListAdapter(input_dims, hidden_dim)
        self.token_adapter = _ListAdapter(tuple(reversed(token_dims)), hidden_dim)
        self.camera_layer = CameraHeadV1(hidden_dim, num_heads, expansion)
        self.depth_layer = DepthHeadV1(hidden_dim, num_heads, expansion, tuple(depths))
        self.level_embeds = nn.Parameter(torch.zeros(n, hidden_dim))
        self.level_embed_layer = nn.Sequential(
            nn.Linear(hidden_dim, hidden_dim), nn.GELU(), nn.Linear(hidden_dim, hidden_dim),
            nn.LayerNorm(hidden_dim, eps=1e-5),
        )

    def forward(self, features, cls_tokens, image_shape, rays_gt=None, skip_camera=False, K_gt=None):
        """features: per level (B, h, w, C); cls_tokens: (B, 1, C) in the
        encoder's order; image_shape (H, W); rays_gt (B, H*W, 3) and K_gt
        (B, 3, 3) optional. Returns K, the three depth maps (B, 2^i h, 2^i
        w, 1) and the 1/16 latents. Inside V1's ``infer()`` a CUDA graph of
        this body may run instead (``models/stage_graphs.py``)."""
        return stage_graphs.call(self, self._forward, features, cls_tokens, tuple(image_shape), rays_gt,
                                 skip_camera, K_gt)

    def _forward(self, features, cls_tokens, image_shape, rays_gt, skip_camera, K_gt):
        H, W = image_shape
        b = features[0].shape[0]
        device = features[0].device
        with tracing.span("unidepth.decoder.camera", device):
            # the common grid: the second-smallest level shape (1/16 for a
            # ConvNeXt pyramid, every level's for a ViT)
            level_shapes = sorted({tuple(f.shape[1:3]) for f in features}, reverse=True)
            gh, gw = level_shapes[-2] if len(level_shapes) > 1 else level_shapes[0]
            feats = [
                adapter(flat_interpolate(f.reshape(b, -1, f.shape[-1]), old=tuple(f.shape[1:3]), new=(gh, gw)))
                for adapter, f in zip(self.input_adapter.input_adapters, features)
            ]
            cams = [adapter(t) for adapter, t in zip(self.token_adapter.input_adapters, cls_tokens[::-1])]
            cls_cat = torch.cat(cams, dim=1)

            fc1, _, fc2, norm = self.level_embed_layer
            le = layer_norm(norm, fc2(F.gelu(fc1(self.level_embeds.to(fc1.weight.dtype)))))
            n, hidden = le.shape
            # each level's embedding over its grid's tokens, in level order
            level_embed = le[:, None].expand(n, gh * gw, hidden).reshape(1, n * gh * gw, hidden).expand(b, -1, -1)
            pos_embed = _sine_grid(gh, gw, hidden, le.device).repeat(len(feats), 1)[None].expand(b, -1, -1)

            if skip_camera and K_gt is not None:
                intrinsics, rays = K_gt, rays_gt
            else:
                intrinsics = self.camera_layer(feats, cls_cat, pos_embed + level_embed, (H, W))
                rays = generate_rays(intrinsics, (H, W))[0] if rays_gt is None else rays_gt
        with tracing.span("unidepth.decoder.depth", device):
            outs, depth_features = self.depth_layer(feats, rays, pos_embed, level_embed, (gh, gw), (H, W))
        return intrinsics, outs, depth_features

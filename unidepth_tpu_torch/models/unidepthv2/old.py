"""UniDepthV2old (counterpart of unidepth_tpu/models/unidepthv2/old.py).

The intermediate architecture: V1's adapters and level embeddings, a camera
head and a global head (a scale and a shift) regressed from cls tokens by
two one-head cross-attention blocks each, and a depth head of camera
prompting, Nystrom blocks and pixel-shuffle upsamplers
(``nn.upsample.ConvUpsampleShuffleResidual``) whose log-depth is
normalised over the whole map, then ``softplus(10 (exp(n) + shift) scale) /
10``. The resolution is chosen by a token budget (``_shapes``), not a
pixel one.

Kernels: the DINOv2 encoder runs K1 and K2 (bf16) or K4 (int8), and each
upsampler's two CvnxtBlocks run K2. Nothing else is a kernel, as in JAX:
``aggregate_16`` and ``prompt_camera`` are one head of D = hidden (> 128),
the heads attend from at most 4 queries, and the Nystrom blocks are
landmark attention in plain ops (``nn.nystrom``).

Tokens are (B, N, C), maps channel-last, as in the JAX package. Module
names are the reference checkpoint's. Compute dtype is the parameters'
(bf16 on the card, fp32 on the CPU, ``from_config``); the whole-map norm,
the heads' regressions and every output are fp32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unidepth_tpu_torch.geometry.rays import generate_rays, spherical_zbuffer_to_euclidean
from unidepth_tpu_torch.models.backbones.dinov2 import VIT_PRESETS, DinoViT, ViTConfig
from unidepth_tpu_torch.models.serving import ServingPrecisionMixin
from unidepth_tpu_torch.models.unidepthv1.decoder import _ListAdapter
from unidepth_tpu_torch.models.unidepthv2.model import (
    UniDepthV2,
    compute_dtype,
    lecun_normal,
    resolve_device,
    trunc_normal,
)
from unidepth_tpu_torch.nn.conv import Conv2d
from unidepth_tpu_torch.nn.layers import MLP, AttentionBlock, LayerScale, layer_norm
from unidepth_tpu_torch.nn.nystrom import NystromBlock
from unidepth_tpu_torch.nn.upsample import ConvUpsampleShuffleResidual, CvnxtBlock
from unidepth_tpu_torch.ops.fourier import generate_fourier_features, position_embedding_sine
from unidepth_tpu_torch.ops.quant import quantizable_linears
from unidepth_tpu_torch.ops.resize import flat_interpolate, resize
from unidepth_tpu_torch.utils.constants import IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD


def _embed_rays_old(rays, old_shape, new_shape, camera_dim: int) -> torch.Tensor:
    """Rays (B, H*W, 3) resized (antialiased bilinear) to ``new_shape``,
    renormalised, as log-spaced Fourier features plus the rays: (B, N,
    camera_dim + 3) fp32."""
    r = flat_interpolate(rays.float(), old=old_shape, new=new_shape, antialias=True)
    r = r / torch.linalg.norm(r, dim=-1, keepdim=True).clamp_min(1e-12)
    return generate_fourier_features(r, dim=camera_dim, max_freq=max(new_shape) // 2, use_log=True, cat_orig=True)


def _cls_heads(hidden_dim: int, expansion: int):
    return (AttentionBlock(hidden_dim, num_heads=1, expansion=expansion),
            AttentionBlock(hidden_dim, num_heads=1, expansion=expansion))


class CameraHeadOld(nn.Module):
    """Four camera cls tokens and every level's tokens -> K (B, 3, 3): fx,
    fy = exp(.) max(H, W) / 2, cx = sigmoid(.) W, cy = sigmoid(.) H."""

    def __init__(self, hidden_dim: int, expansion: int = 4):
        super().__init__()
        self.project_cls = MLP(hidden_dim, expansion=4)
        self.latents_pos = nn.Parameter(torch.zeros(1, 4, hidden_dim))
        self.in_features = MLP(hidden_dim, expansion=2)
        self.aggregate1, self.aggregate2 = _cls_heads(hidden_dim, expansion)
        self.out = MLP(hidden_dim, expansion=2, output_dim=1)

    def forward(self, features, cls_tokens, pos_embed, original_shapes):
        cls_tokens = self.project_cls(cls_tokens)
        pos = self.latents_pos.to(cls_tokens.dtype).expand(cls_tokens.shape[0], -1, -1)
        stack = self.in_features(torch.cat(features, dim=1) + pos_embed.to(cls_tokens.dtype))
        context = torch.cat([stack, cls_tokens], dim=1)
        x = self.aggregate1(cls_tokens, context=context, pos_embed=pos)
        x = self.aggregate2(x, context=context, pos_embed=pos)
        x = self.out(x)[..., 0].float()
        h, w = original_shapes
        half = max(original_shapes) / 2.0
        fx, fy = torch.exp(x[:, 0]) * half, torch.exp(x[:, 1]) * half
        cx, cy = torch.sigmoid(x[:, 2]) * w, torch.sigmoid(x[:, 3]) * h
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack(
            [torch.stack([fx, z, cx], -1), torch.stack([z, fy, cy], -1), torch.stack([z, z, o], -1)], dim=-2
        )


class GlobalHeadOld(nn.Module):
    """Two global cls tokens, every level's tokens and the rays -> scale =
    exp(.) and shift, each (B, 1, 1, 1) fp32."""

    def __init__(self, hidden_dim: int, camera_dim: int = 96, expansion: int = 4):
        super().__init__()
        self.camera_dim = camera_dim
        self.project_cls = MLP(hidden_dim, expansion=4)
        self.project_rays = nn.Linear(camera_dim + 3, hidden_dim)
        self.in_features = nn.Linear(hidden_dim, hidden_dim)
        self.aggregate1, self.aggregate2 = _cls_heads(hidden_dim, expansion)
        self.out = MLP(hidden_dim, expansion=2, output_dim=1)

    def forward(self, features, cls_tokens, rays, shapes, original_shapes):
        cls_tokens = self.project_cls(cls_tokens)
        remb = self.project_rays(_embed_rays_old(rays, original_shapes, shapes, self.camera_dim).to(cls_tokens.dtype))
        stack = self.in_features(torch.cat(features, dim=1) + remb.repeat(1, len(features), 1))
        context = torch.cat([stack, cls_tokens], dim=1)
        x = self.aggregate2(self.aggregate1(cls_tokens, context=context), context=context)
        x = self.out(x)[..., 0].float()
        return torch.exp(x[:, 0]).reshape(-1, 1, 1, 1), x[:, 1].reshape(-1, 1, 1, 1)


class DepthHeadOld(nn.Module):
    """Features at the patch grid -> log-depth and confidence (B, H, W, 1)
    at the image shape, fp32, and the last upsampler's tokens."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, expansion: int = 4, depths: tuple[int, ...] = (6, 0, 0),
                 camera_dim: int = 96, num_inputs: int = 4):
        super().__init__()
        hd = hidden_dim
        self.camera_dim = camera_dim
        dims = [hd // 2**i for i in range(len(depths))]
        self.rays_layers = nn.ModuleList([nn.Linear(camera_dim + 3, d) for d in dims])
        self.features_channel_cat = nn.Linear(num_inputs * hd, hd)
        self.to_latents = MLP(hd, expansion=2)
        self.aggregate_16 = AttentionBlock(hd, num_heads=1, expansion=expansion, context_dim=hd)
        self.prompt_camera = AttentionBlock(hd, num_heads=1, expansion=expansion, context_dim=hd)
        self.process_layers = nn.ModuleList(
            [nn.ModuleList([NystromBlock(d, max(1, num_heads >> i), expansion) for _ in range(n)])
             for i, (d, n) in enumerate(zip(dims, depths))]
        )
        self.ups = nn.ModuleList([ConvUpsampleShuffleResidual(d, expansion) for d in dims])
        self.depth_mlp = nn.ModuleList([MLP(d // 2, expansion=1, output_dim=16) for d in dims])
        self.confidence_mlp = nn.ModuleList([MLP(d // 2, expansion=1, output_dim=16) for d in dims])
        self.to_depth = Conv2d(16 * len(dims), 1, kernel_size=7, padding_mode="reflect")
        self.to_confidence = Conv2d(16 * len(dims), 1, kernel_size=7, padding_mode="reflect")

    def forward(self, features, rays_hr, pos_embed, level_embed, shapes, original_shapes):
        b = features[0].shape[0]
        gh, gw = shapes
        dtype = self.features_channel_cat.weight.dtype
        rembs = [
            layer(_embed_rays_old(rays_hr, original_shapes, (gh * 2**i, gw * 2**i), self.camera_dim).to(dtype))
            for i, layer in enumerate(self.rays_layers)
        ]
        f16 = self.features_channel_cat(torch.cat(features, dim=-1))
        latents = f16 + self.to_latents(f16)
        latents = self.aggregate_16(latents, context=torch.cat(features, dim=1),
                                    pos_embed_context=(pos_embed + level_embed).to(dtype))
        latents = self.prompt_camera(latents, context=rembs[0])

        out_features = []
        cur = (gh, gw)
        for layers, remb, up in zip(self.process_layers, rembs, self.ups):
            for layer in layers:
                latents = layer(latents, pos_embed=remb)
            latents = up((latents + remb).reshape(b, *cur, -1))
            cur = (2 * cur[0], 2 * cur[1])
            out_features.append(latents.reshape(b, *cur, -1))

        def fuse(mlps, conv):
            maps = [resize(mlps[i](out_features[i]), original_shapes, mode="bilinear", align_corners=False)
                    for i in reversed(range(len(out_features)))]
            return conv(torch.cat(maps, dim=-1).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

        logdepth = fuse(self.depth_mlp, self.to_depth).float()
        confidence = torch.sigmoid(fuse(self.confidence_mlp, self.to_confidence).float())
        return logdepth, confidence, latents


class DecoderV2Old(nn.Module):
    """The V2old decoder. ``forward(features, camera_tokens, global_tokens,
    image_shape, rays_gt=None)``: features per level (B, h, w, C), the four
    camera and two global cls tokens (B, 1, C). Returns K, depth and
    confidence (B, H, W, 1), the depth head's last tokens and the rays
    (B, H*W, 3): ``rays_gt`` where given, else those of K."""

    def __init__(self, input_dims: tuple[int, ...], hidden_dim: int, num_heads: int = 8, expansion: int = 4,
                 depths: tuple[int, ...] = (6, 0, 0), camera_dim: int = 96):
        super().__init__()
        n = len(input_dims)
        self.input_adapter = _ListAdapter(input_dims, hidden_dim)
        self.camera_token_adapter = _ListAdapter((input_dims[-1],) * 4, hidden_dim)
        self.global_token_adapter = _ListAdapter((input_dims[-1],) * 2, hidden_dim)
        self.camera_layer = CameraHeadOld(hidden_dim, expansion)
        self.global_layer = GlobalHeadOld(hidden_dim, camera_dim, expansion)
        self.depth_layer = DepthHeadOld(hidden_dim, num_heads, expansion, tuple(depths), camera_dim, n)
        self.level_embeds = nn.Parameter(torch.zeros(n, hidden_dim))
        self.level_embed_layer = nn.Sequential(
            nn.Linear(hidden_dim, hidden_dim), nn.GELU(), nn.Linear(hidden_dim, hidden_dim),
            nn.LayerNorm(hidden_dim, eps=1e-5),
        )

    def forward(self, features, camera_tokens, global_tokens, image_shape, rays_gt=None):
        H, W = image_shape
        b, gh, gw, _ = features[0].shape
        feats = [ad(f.reshape(b, gh * gw, -1)) for ad, f in zip(self.input_adapter.input_adapters, features)]
        cam_cls = torch.cat([ad(t) for ad, t in zip(self.camera_token_adapter.input_adapters, camera_tokens)], dim=1)
        glob_cls = torch.cat([ad(t) for ad, t in zip(self.global_token_adapter.input_adapters, global_tokens)], dim=1)

        fc1, _, fc2, norm = self.level_embed_layer
        le = layer_norm(norm, fc2(F.gelu(fc1(self.level_embeds.to(fc1.weight.dtype)))))
        hidden = le.shape[-1]
        level_embed = le.repeat_interleave(gh * gw, dim=0)[None].expand(b, -1, -1)
        pos = position_embedding_sine(gh, gw, num_pos_feats=hidden // 2, normalize=True, device=le.device)
        pos_embed = pos.reshape(1, gh * gw, hidden).repeat(1, len(feats), 1).expand(b, -1, -1)

        K = self.camera_layer(feats, cam_cls, pos_embed + level_embed, (H, W))
        rays = generate_rays(K, (H, W))[0] if rays_gt is None else rays_gt
        scale, shift = self.global_layer(feats, glob_cls, rays, (gh, gw), (H, W))
        logdepth, confidence, depth_features = self.depth_layer(feats, rays, pos_embed, level_embed, (gh, gw), (H, W))
        # log-depth normalised over the whole map (population variance, as
        # jnp.var), then the global scale and shift and a softplus
        mean = logdepth.mean(dim=(1, 2, 3), keepdim=True)
        var = logdepth.var(dim=(1, 2, 3), keepdim=True, correction=0)
        depth = (torch.exp((logdepth - mean) / torch.sqrt(var + 1e-5)) + shift) * scale
        depth = torch.logaddexp(depth * 10.0, torch.zeros((), dtype=depth.dtype, device=depth.device)) / 10.0
        return {"K": K, "depth": depth, "confidence": confidence, "depth_features": depth_features, "rays": rays}


class UniDepthV2old(ServingPrecisionMixin, nn.Module):
    """DINOv2 encoder ('last' stacking) + ``DecoderV2Old`` with the reference
    checkpoint's state_dict keys (``pixel_encoder.*``, ``pixel_decoder.*``)."""

    PATCH = 14
    RESOLUTION_LEVELS = 10

    def __init__(self, encoder_cfg: ViTConfig, hidden_dim: int = 512, decoder_depths: tuple[int, ...] = (6, 0, 0),
                 num_heads: int = 8, expansion: int = 4, pixels_bounds: tuple[int, int] = (1400, 2400)):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.pixel_encoder = DinoViT(encoder_cfg, stacking="last")
        self.pixel_decoder = DecoderV2Old(
            input_dims=(encoder_cfg.embed_dim,) * len(encoder_cfg.output_idx),
            hidden_dim=hidden_dim,
            num_heads=num_heads,
            expansion=expansion,
            depths=tuple(decoder_depths),
        )
        self.pixels_bounds = tuple(pixels_bounds)  # in tokens
        self.resolution_level: int | None = None
        self.attention_logit_bound = None
        self._init_serving()

    @classmethod
    def from_config(cls, config: dict, device=None, dtype: torch.dtype | None = None) -> "UniDepthV2old":
        """Build from a reference-schema config dict, on ``device`` (default
        ``cuda``; without a card pass ``device="cpu"``) in ``dtype`` (default:
        bf16 on the card, fp32 on the CPU). The encoder is the DINOv2 preset
        the config names with its ``output_idx`` (default the last four
        blocks) and ``use_norm``; the ViT keys the V2 configs carry
        (``embed_dim``, ``depth``, ``num_heads``, ``pos_embed_size``)
        override the preset."""
        device = resolve_device(device)
        pe = config["model"]["pixel_encoder"]
        vit = VIT_PRESETS[pe["name"].replace("dinov2_", "")]
        depth = pe.get("depth", vit.depth)
        enc_cfg = ViTConfig(
            embed_dim=pe.get("embed_dim", vit.embed_dim),
            depth=depth,
            num_heads=pe.get("num_heads", vit.num_heads),
            pos_embed_size=pe.get("pos_embed_size", vit.pos_embed_size),
            output_idx=tuple(pe.get("output_idx", (depth - 3, depth - 2, depth - 1, depth))),
            use_norm=pe.get("use_norm", False),
        )
        dec = config["model"]["pixel_decoder"]
        model = cls(
            enc_cfg,
            hidden_dim=dec["hidden_dim"],
            decoder_depths=tuple(dec.get("depths", (6, 0, 0))),
            num_heads=config["model"].get("num_heads", 8),
            expansion=config["model"].get("expansion", 4),
        )
        model.attention_logit_bound = config["model"].get("attention_logit_bound")
        return model.to(device=device, dtype=dtype or compute_dtype(device))

    @classmethod
    def from_pretrained(cls, name_or_path, device=None, dtype: torch.dtype | None = None,
                        config: dict | None = None) -> "UniDepthV2old":
        """Load a local checkpoint (``io.hub.load_checkpoint``: a directory
        or a weights file, the config from ``config``, a ``config.json`` or
        the shipped V2old config of the backbone the path names), placed as
        ``from_config`` places it (default ``cuda``)."""
        from unidepth_tpu_torch.io.hub import load_checkpoint

        device = resolve_device(device)  # before the checkpoint is read
        config, state_dict = load_checkpoint(name_or_path, version="2old", config=config)
        model = cls.from_config(config, device=device, dtype=dtype)
        model.load_state_dict(model.select_checkpoint_keys(state_dict))
        return model

    # the same checkpoint entries go unused, and the same kernel switch, as in V2
    select_checkpoint_keys = UniDepthV2.select_checkpoint_keys
    set_kernels = UniDepthV2.set_kernels

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "UniDepthV2old":
        """Random weights drawn on the CPU from ``torch.Generator(seed)`` with
        the JAX initializers' distributions: lecun-normal (truncated) dense
        and conv kernels (depthwise ones by their 49 taps), truncated normal
        0.02 for the patch and position embeddings, normal 1.0 for the
        camera latents and level embeddings, layer scales at their init
        value, zero biases and cls token, unit LayerNorm scales. Where the
        model holds the encoder linears below fp32, their fp32 draws are kept
        as the int8 path's masters."""
        g = torch.Generator().manual_seed(seed)
        drawn = {}

        def put(p, value):
            p.copy_(value)
            drawn[id(p)] = value

        enc = self.pixel_encoder
        for m in self.modules():
            if m is enc.patch_embed.proj:
                put(m.weight, trunc_normal(m.weight.shape, 0.02, g))
                put(m.bias, torch.zeros(m.bias.shape))
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                put(m.weight, lecun_normal(m.weight.shape, m.weight[0].numel(), g))
                put(m.bias, torch.zeros(m.bias.shape))
            elif isinstance(m, nn.LayerNorm):
                put(m.weight, torch.ones(m.weight.shape))
                put(m.bias, torch.zeros(m.bias.shape))
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_value)
            elif isinstance(m, CvnxtBlock):
                m.gamma.fill_(1.0)
        put(enc.cls_token, torch.zeros(enc.cls_token.shape))
        put(enc.pos_embed, trunc_normal(enc.pos_embed.shape, 0.02, g))
        dec = self.pixel_decoder
        for p in (dec.camera_layer.latents_pos, dec.level_embeds):
            p.copy_(torch.randn(p.shape, generator=g))
        self._set_fp32_masters(
            {name: (drawn[id(m.weight)], drawn[id(m.bias)]) for name, m in quantizable_linears(enc).items()}
        )
        return self

    def _shapes(self, image_shape):
        """The network shape for ``image_shape`` and its scale: the aspect
        ratio kept, the patch grid sized to the token budget of the
        resolution level (default the highest), rounded to whole patches."""
        h, w = image_shape
        ratio = w / h
        lo, hi = sorted(self.pixels_bounds)
        lvl = self.RESOLUTION_LEVELS if self.resolution_level is None else self.resolution_level
        lvl = min(max(lvl, 0), self.RESOLUTION_LEVELS)
        tokens = lo + math.ceil((hi - lo) * lvl / self.RESOLUTION_LEVELS)
        th = math.ceil((tokens / ratio) ** 0.5 - 0.5)
        tw = math.ceil(th * ratio - 0.5)
        return (th * self.PATCH, tw * self.PATCH), th / h * self.PATCH

    def _forward(self, encoder, image, rays_gt=None, generator=None) -> dict:
        """Encoder and decoder on a normalised batch at the network shape."""
        _, h, w, _ = image.shape
        feats, cls_tokens = encoder(image, generator=generator)
        cam = [cls_tokens[-3], cls_tokens[-2], cls_tokens[-1], cls_tokens[-2]]
        glob = [cls_tokens[-2], cls_tokens[-1]]
        return self.pixel_decoder(feats, cam, glob, (h, w), rays_gt=rays_gt)

    def encode_decode(self, image, rays_gt=None, generator: torch.Generator | None = None) -> dict:
        """The train and eval forward on a normalised batch (B, H, W, 3), H
        and W multiples of 14, moved to the model's device and dtype: the
        decoder's outputs (``K``, ``depth``, ``confidence``,
        ``depth_features``, ``rays``) plus ``points`` along the rays of K.
        ``generator`` turns on the encoder's stochastic depth where its rate
        is positive; as in JAX, ``from_config`` leaves V2old's at 0."""
        p = next(self.parameters())
        _, h, w, _ = image.shape
        if rays_gt is not None:
            rays_gt = rays_gt.to(p.device)
        out = self._forward(self.pixel_encoder, image.to(p.device, p.dtype), rays_gt, generator)
        angles = generate_rays(out["K"], (h, w))[1].reshape(-1, h, w, 2)
        out["points"] = spherical_zbuffer_to_euclidean(torch.cat([angles, out["depth"]], dim=-1))
        return out

    @torch.inference_mode()
    def infer(self, rgbs, intrinsics=None) -> dict:
        """rgbs: (H,W,3) | (B,H,W,3) channel-last or (3,H,W) | (B,3,H,W)
        channel-first, 0..255, numpy or torch. intrinsics: optional (3,3) /
        (B,3,3) K, never written; its rays replace the predicted ones.
        Returns channel-last float32 ``depth`` and ``confidence`` (B, H, W,
        1), ``points`` (B, H, W, 3) and ``intrinsics`` (B, 3, 3) at the
        input size."""
        p = next(self.parameters())
        device, dtype = p.device, p.dtype
        rgb = torch.as_tensor(np.asarray(rgbs) if not torch.is_tensor(rgbs) else rgbs)
        if rgb.ndim == 3:
            rgb = rgb[None]
        if rgb.shape[1] == 3 and rgb.shape[-1] != 3:
            rgb = rgb.permute(0, 2, 3, 1)
        rgb = rgb.to(device).float()
        B, H, W, _ = rgb.shape
        (sh, sw), ratio = self._shapes((H, W))
        mean = torch.tensor(IMAGENET_DATASET_MEAN, device=device) * 255.0
        std = torch.tensor(IMAGENET_DATASET_STD, device=device) * 255.0
        x = resize((rgb - mean) / std, (sh, sw), mode="bilinear", align_corners=False, antialias=True)
        # fx, cx, fy and cy scale with the image (the first two rows of K)
        scale = torch.tensor([[ratio], [ratio], [1.0]], device=device)
        rays_gt = None
        if intrinsics is not None:
            K = torch.as_tensor(np.asarray(intrinsics) if not torch.is_tensor(intrinsics) else intrinsics)
            K = K.to(device=device, dtype=torch.float32)
            K = (K[None] if K.ndim == 2 else K).expand(B, 3, 3)
            rays_gt = generate_rays(K * scale, (sh, sw))[0]

        out = self._forward(self._serving_encoder(), x.to(dtype), rays_gt)
        depth = resize(out["depth"], (H, W), mode="nearest-exact")
        confidence = resize(out["confidence"], (H, W), mode="bilinear", align_corners=False, antialias=True)
        K_out = out["K"] / scale
        angles = generate_rays(K_out, (H, W))[1].reshape(-1, H, W, 2)
        points = spherical_zbuffer_to_euclidean(torch.cat([angles, depth], dim=-1))
        return {"depth": depth, "confidence": confidence, "intrinsics": K_out, "points": points}

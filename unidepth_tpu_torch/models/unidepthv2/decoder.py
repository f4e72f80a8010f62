"""UniDepthV2 decoder (counterpart of unidepth_tpu/models/unidepthv2/decoder.py).

The camera head regresses (fx, fy, cx, cy) from the encoder cls tokens; the
predicted (or given) rays condition the depth head through four
camera-prompt cross-attentions (kernel K3 through ``ops.attention``); a
ConvTranspose feature pyramid and residual bilinear upsamplers produce
log-depth and log-confidence.

Layouts: tokens are (B, N, C) and the public outputs channel-last, as in the
JAX package. Inside ``DepthHead`` the spatial maps are held NCHW for
``nn.Conv2d``. Submodule names are the reference checkpoint's.

Each head's high-resolution tail (``_hr_head``: reflect 3x3 conv, LeakyReLU,
1x1 conv to one channel) runs as one launch of kernel K5
(``ops.conv_kernels.conv3x3_head``) where the map is a CUDA bf16 tensor that
needs no gradient and its channels fit K5's Hopper body (``_hr_on_k5``):
bf16 serving. The resize before it then casts its fp32 result to bf16 NHWC
in memory, so K5 reads the full-resolution map in place. Everything else
(the CPU, fp32, training under autograd, ``set_kernels(False)`` and so the
exporter) runs the modules.

Both heads' ``Linear(LayerNorm(latents))`` (``depth_mlp``, ``confidence_mlp``)
run as one launch of kernel K2h (``ops.head_mlp``) where the latents are a
CUDA bf16 map that needs no gradient, both pairs are plain bf16
``nn.LayerNorm`` / ``nn.Linear`` of the latents' width and the shape fits the
kernel (``_mlps_on_k2h``): the kernel reads the NCHW latents in place and
writes each head's NHWC map, the layout ``nn.Linear`` gives them. Everything
else (the CPU, fp32, autograd, ``set_kernels(False)``, an int8 linear, other
widths) runs the modules.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from unidepth_tpu_torch.geometry.coords import coords_grid
from unidepth_tpu_torch.models import stage_graphs
from unidepth_tpu_torch.nn.conv import Conv2d, PatchConvTranspose
from unidepth_tpu_torch.nn.layers import MLP, AttentionBlock, AttentionLayer, layer_norm
from unidepth_tpu_torch.nn.upsample import ResUpsampleBil
from unidepth_tpu_torch.ops.conv_kernels import MAX_CIN, MAX_COUT, conv3x3_head
from unidepth_tpu_torch.ops.fourier import generate_fourier_features
from unidepth_tpu_torch.ops.head_mlp import fits as k2h_fits
from unidepth_tpu_torch.ops.head_mlp import head_mlp
from unidepth_tpu_torch.ops.resize import flat_interpolate, resize
from unidepth_tpu_torch.utils import tracing


def _to_nchw(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return tokens.reshape(tokens.shape[0], h, w, -1).permute(0, 3, 1, 2)


class CameraHead(nn.Module):
    """cls tokens (B, 4, C) -> (B, 4) pinhole parameters (fx, fy, cx, cy)."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, expansion: int = 4, layer_scale: float = 1.0):
        super().__init__()
        self.latents_pos = nn.Parameter(torch.zeros(1, 4, hidden_dim))
        self.project = MLP(hidden_dim, expansion=1, output_dim=hidden_dim)
        block = dict(num_heads=num_heads, expansion=expansion, layer_scale=layer_scale, use_bias=False)
        self.aggregate1 = AttentionBlock(hidden_dim, **block)
        self.aggregate2 = AttentionBlock(hidden_dim, **block)
        self.out_pinhole = MLP(hidden_dim, expansion=1, output_dim=1)

    def forward(self, cls_tokens: torch.Tensor, shapes: tuple[int, int]) -> torch.Tensor:
        pos = self.latents_pos.expand(cls_tokens.shape[0], -1, -1)
        tokens = self.project(cls_tokens)
        tokens = self.aggregate1(tokens, pos_embed=pos)
        tokens = self.aggregate2(tokens, pos_embed=pos)
        x = self.out_pinhole(tokens)[..., 0].float()
        h, w = shapes
        diag = math.sqrt(h * h + w * w)
        fx = torch.exp(x[:, 0]) * (0.7 * diag)
        fy = torch.exp(x[:, 1]) * (0.7 * diag)
        cx = torch.sigmoid(x[:, 2]) * w
        cy = torch.sigmoid(x[:, 3]) * h
        return torch.stack([fx, fy, cx, cy], dim=1)


class DepthHead(nn.Module):
    """Camera-conditioned multi-scale depth and confidence decoder."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int = 8,
        expansion: int = 4,
        depths: tuple[int, ...] = (2, 2, 2),
        out_dim: int = 64,
        kernel_size: int = 3,
        layer_scale: float = 1.0,
    ):
        super().__init__()
        hd = hidden_dim
        self.hidden_dim = hd
        self.prompt_camera = nn.ModuleList(
            [
                AttentionLayer(1, hd, num_heads=num_heads, expansion=expansion, layer_scale=-1.0,
                               context_dim=hd, use_bias=False)
                for _ in range(4)
            ]
        )
        self.to_latents = nn.Linear(hd, hd)
        process, ups = [], []
        for i, depth in enumerate(depths):
            current_dim = min(hd, 2 * hd // 2**i)
            output_dim = max(2 * hd // 2 ** (i + 1), out_dim)
            # level i's conditioning map must reach the 2^i-upsampled latents
            process.append(PatchConvTranspose(hd, current_dim, scale=2**i))
            ups.append(ResUpsampleBil(current_dim, output_dim, depth, kernel_size, layer_scale))
        self.process_features = nn.ModuleList(process)
        self.ups = nn.ModuleList(ups)
        final_dim = output_dim
        # only the last level's depth projection exists (reference key depth_mlp.{last})
        self.depth_mlp = nn.ModuleDict(
            {str(len(depths) - 1): nn.Sequential(nn.LayerNorm(final_dim, eps=1e-5), nn.Linear(final_dim, final_dim))}
        )
        self.confidence_mlp = nn.Sequential(nn.LayerNorm(final_dim, eps=1e-5), nn.Linear(final_dim, final_dim))
        self.to_depth_lr = Conv2d(final_dim, final_dim // 2, 3, padding_mode="reflect")
        self.to_confidence_lr = Conv2d(final_dim, final_dim // 2, 3, padding_mode="reflect")
        self.to_depth_hr = self._hr_head(final_dim // 2)
        self.to_confidence_hr = self._hr_head(final_dim // 2)
        self.use_kernels = True

    @staticmethod
    def _hr_head(in_dim: int) -> nn.Sequential:
        return nn.Sequential(
            Conv2d(in_dim, 32, 3, padding_mode="reflect"), nn.LeakyReLU(0.01), Conv2d(32, 1, 1, padding=0)
        )

    def embed_rays(self, rays, shapes, original_shapes):
        """rays (B, H*W, 3) at the input resolution -> Fourier embedding of
        their polar and azimuth angles at the token grid, in fp32."""
        r = flat_interpolate(rays.float(), old=original_shapes, new=shapes, antialias=True)
        r = r / torch.linalg.norm(r, dim=-1, keepdim=True).clamp_min(1e-4)
        x, y, z = r.unbind(-1)
        # strictly inside (-1, 1): d/dz arccos diverges at |z| = 1
        polar = torch.arccos(z.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
        x_c = x.abs().clamp_min(1e-3) * torch.where(x >= 0, 1.0, -1.0)
        azimuth = torch.atan2(y, x_c)
        ang = torch.stack([polar, azimuth], dim=-1)
        return generate_fourier_features(ang, dim=self.hidden_dim, max_freq=max(shapes) // 2, use_log=True)

    def _hr_on_k5(self, y: torch.Tensor, hr: nn.Sequential, out_hw) -> bool:
        """Whether ``hr`` runs as K5's fused launch on the map ``y``: kernels
        on, a CUDA bf16 map that needs no gradient, Cin and Cout multiples of
        8 within K5's Hopper body, one output channel, H and W >= 2."""
        conv, _, proj = hr
        needs_grad = torch.is_grad_enabled() and (y.requires_grad or any(p.requires_grad for p in hr.parameters()))
        cin, cout = conv.in_channels, conv.out_channels
        return (self.use_kernels and y.is_cuda and y.dtype == torch.bfloat16 and not needs_grad
                and cin <= MAX_CIN and cin % 8 == 0 and cout <= MAX_COUT and cout % 8 == 0
                and proj.out_channels == 1 and min(out_hw) >= 2)

    def _mlps_on_k2h(self, latents: torch.Tensor, mlps: list) -> bool:
        """Whether the heads' ``(LayerNorm, Linear)`` pairs ``mlps`` run as
        one K2h launch on ``latents``: kernels on, a CUDA bf16 map that needs
        no gradient, every pair a plain ``nn.LayerNorm`` and ``nn.Linear``
        of the latents' width C with bf16 weights and biases (not an int8 or
        a tensor-parallel linear), and C and the grid within the kernel's
        envelope."""
        _, c, h, w = latents.shape
        params = [p for mlp in mlps for p in mlp.parameters()]
        needs_grad = torch.is_grad_enabled() and (latents.requires_grad or any(p.requires_grad for p in params))
        plain = all(type(norm) is nn.LayerNorm and type(linear) is nn.Linear and norm.weight is not None
                    and norm.bias is not None and linear.bias is not None and norm.normalized_shape == (c,)
                    and linear.weight.shape == (c, c) for norm, linear in mlps)
        return (self.use_kernels and latents.is_cuda and latents.dtype == torch.bfloat16 and not needs_grad
                and plain and all(p.dtype == torch.bfloat16 for p in params) and k2h_fits(c, h, w))

    def _head(self, y, lr: nn.Module, hr: nn.Sequential, out_hw):
        """One head from its MLP's (B, H, W, C) output ``y`` (when the caller
        holds no other reference, it is freed once the lr conv has read it)."""
        y = lr(y.permute(0, 3, 1, 2))
        if not self._hr_on_k5(y, hr, out_hw):
            return hr(resize(y, out_hw, mode="bilinear", align_corners=True, channel_last=False))
        y = resize(y, out_hw, mode="bilinear", align_corners=True, channel_last=False, nhwc=True)
        conv, act, proj = hr
        out = conv3x3_head(y.permute(0, 2, 3, 1), conv.weight.permute(2, 3, 1, 0), conv.bias,
                           proj.weight.reshape(-1), proj.bias, conv.padding_mode, act.negative_slope)
        return out.view(out.shape[0], 1, *out.shape[1:3])  # (B, H, W, 1) is (B, 1, H, W) in memory

    def prompt(self, features, rays_hr, shapes, original_shapes):
        """features: 4 x (B, N, hidden); rays_hr (B, H*W, 3). The features
        conditioned on the rays' embedding, and the (B, N, hidden) initial
        latents."""
        dtype = self.to_latents.weight.dtype
        rays_embedding = self.embed_rays(rays_hr, shapes, original_shapes).to(dtype)
        conditioned = [p(f, context=rays_embedding) for p, f in zip(self.prompt_camera, features)]
        return conditioned, self.to_latents(conditioned[0])

    def pyramid(self, conditioned, init_latents, shapes):
        """The NCHW latents of the last level of the feature pyramid."""
        h, w = shapes
        latents = _to_nchw(init_latents, h, w)
        for i, up in enumerate(self.ups):
            latents = up(latents + self.process_features[i](_to_nchw(conditioned[i + 1], h, w)))
        return latents

    def heads(self, latents, original_shapes, confidence: bool = True):
        """NCHW log-depth and log-confidence (None unless ``confidence``) at
        ``original_shapes`` from the NCHW latents. Where both heads' MLPs run
        as one K2h launch, nothing reads the latents after it: when the
        caller hands over its only reference (``Decoder._forward``), they are
        freed there, and the second head's MLP output takes their place in
        memory while the first head runs at full resolution."""
        (depth_mlp,) = self.depth_mlp.values()
        tails = [(depth_mlp, self.to_depth_lr, self.to_depth_hr)]
        if confidence:
            tails.append((self.confidence_mlp, self.to_confidence_lr, self.to_confidence_hr))
        ys = None
        if self._mlps_on_k2h(latents, [mlp for mlp, _, _ in tails]):
            norms, linears = zip(*(mlp for mlp, _, _ in tails))
            ys = list(head_mlp(latents, [m.weight for m in linears], [m.bias for m in linears],
                               [n.weight for n in norms], [n.bias for n in norms], [n.eps for n in norms]))
            del latents
        outs = []
        for (norm, linear), lr, hr in tails:  # each MLP output goes to _head as its only reference
            if ys is None:
                outs.append(self._head(linear(layer_norm(norm, latents.permute(0, 2, 3, 1))), lr, hr, original_shapes))
            else:
                outs.append(self._head(ys.pop(0), lr, hr, original_shapes))
        return outs[0], outs[1] if confidence else None


class _Adapters(nn.Module):
    def __init__(self, input_dims, hidden_dim: int):
        super().__init__()
        self.input_adapters = nn.ModuleList([nn.Linear(d, hidden_dim) for d in input_dims])


class Decoder(nn.Module):
    """Full V2 decoder."""

    def __init__(
        self,
        input_dims: tuple[int, ...],
        hidden_dim: int,
        num_heads: int = 8,
        expansion: int = 4,
        depths: tuple[int, ...] = (2, 2, 2),
        out_dim: int = 64,
        kernel_size: int = 3,
        layer_scale: float = 1.0,
    ):
        super().__init__()
        self.input_adapter = _Adapters(input_dims, hidden_dim)
        self.camera_token_adapter = _Adapters(input_dims, hidden_dim)
        self.camera_layer = CameraHead(hidden_dim, num_heads, expansion, layer_scale)
        self.depth_layer = DepthHead(hidden_dim, num_heads, expansion, tuple(depths), out_dim, kernel_size, layer_scale)
        # orthonormal level embeddings: carried by checkpoints, unused by the V2 forward
        self.register_buffer("level_embeds", torch.zeros(1, 1, len(input_dims), hidden_dim))

    def run_camera(self, cls_tokens, shapes):
        """Predict intrinsics and back-project the pixel grid to unit rays."""
        h, w = shapes
        intrinsics = self.camera_layer(cls_tokens, shapes)  # (B, 4) fp32
        fx, fy, cx, cy = (intrinsics[:, i, None, None] for i in range(4))
        uv = coords_grid(h, w, device=intrinsics.device)
        x = (uv[None, ..., 0] - cx) / fx
        y = (uv[None, ..., 1] - cy) / fy
        rays = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp_min(1e-5)
        K = torch.zeros(intrinsics.shape[0], 3, 3, device=intrinsics.device)
        K[:, 0, 0], K[:, 1, 1] = intrinsics[:, 0], intrinsics[:, 1]
        K[:, 0, 2], K[:, 1, 2] = intrinsics[:, 2], intrinsics[:, 3]
        K[:, 2, 2] = 1.0
        return K, rays.reshape(rays.shape[0], h * w, 3)

    def forward(self, features, cls_tokens, image_shape, rays_gt=None, confidence: bool = True):
        """features: 4 x (B, h, w, C); cls_tokens: 4 x (B, 1, C); image_shape
        (H, W); rays_gt optional (B, H*W, 3) replacing the predicted rays.
        ``confidence=False`` skips the confidence head. Inside V2's
        ``infer()`` a CUDA graph of this body may run instead
        (``models/stage_graphs.py``)."""
        return stage_graphs.call(self, self._forward, features, cls_tokens, tuple(image_shape), rays_gt, confidence)

    def _forward(self, features, cls_tokens, image_shape, rays_gt, confidence: bool):
        H, W = image_shape
        b, gh, gw, _ = features[0].shape
        device = features[0].device
        head = self.depth_layer
        with tracing.span("unidepth.decoder.camera", device):
            cam_tokens = [a(t) for a, t in zip(self.camera_token_adapter.input_adapters, cls_tokens)]
            intrinsics, rays = self.run_camera(torch.cat(cam_tokens, dim=1), (H, W))
        if rays_gt is not None:
            rays = rays_gt
        with tracing.span("unidepth.decoder.prompt", device):
            feats = [a(f.reshape(b, gh * gw, -1)) for a, f in zip(self.input_adapter.input_adapters, features)]
            conditioned, depth_features = head.prompt(feats, rays, (gh, gw), (H, W))
        with tracing.span("unidepth.decoder.pyramid", device):
            latents = [head.pyramid(conditioned, depth_features, (gh, gw))]
        with tracing.span("unidepth.decoder.heads", device):
            # handed over as heads()'s only reference: K2h's route frees the latents once read
            logdepth, logconf = head.heads(latents.pop(), (H, W), confidence)
            radius = torch.exp(logdepth.float().clamp(-8.0, 8.0) + 2.0).permute(0, 2, 3, 1)
            out = {
                "radius": radius,  # (B, H, W, 1)
                "depth_features": depth_features,  # (B, N, hidden)
                "intrinsics": intrinsics,  # (B, 3, 3)
                "rays": rays,  # (B, H*W, 3)
            }
            if logconf is not None:
                out["confidence"] = torch.exp(logconf.float().clamp(-8.0, 8.0)).permute(0, 2, 3, 1)
        return out

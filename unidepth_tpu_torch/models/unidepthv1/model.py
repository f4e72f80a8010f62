"""UniDepthV1 (counterpart of unidepth_tpu/models/unidepthv1/model.py).

``infer(rgbs, intrinsics, skip_camera)`` resizes and pads the images into
the fixed network shape (462x616 in the shipped configs), runs the encoder
(DINOv2 ViT with ``max_cls`` stacking and the offset-0.1 pos-embed resize,
or ConvNeXt with ``max_cls``) and the V1 decoder, averages the three depth
scales at the network shape, crops the pads, resizes depth back and
back-projects points through the spherical z-buffer. Outputs are
channel-last float32: ``depth`` (B, H, W, 1), ``points`` (B, H, W, 3) and
``intrinsics`` (B, 3, 3). On a card the encoder and the decoder replay CUDA
graphs captured per input shape (``models/stage_graphs.py``); pre- and
postprocessing run eagerly, and nothing in a call makes the host wait for
the device.

Compute dtype is the parameters' dtype: bf16 on the card, float32 on the
CPU (``from_config``). Int8 serving (``ServingPrecisionMixin``) needs the
per-stage calibration first (``INT8_REQUIRES_CALIBRATION``): V1's depth head
exponentiates its logits, so ``set_serving_precision('int8')`` raises until
``calibrate_int8_stages`` has stored a stage mask. The ConvNeXt encoder has
no int8 path and refuses it, as in JAX.

``encode_decode(image, rays_gt, K_gt, skip_camera, generator)`` is the
train and eval forward; ``generator`` turns on either encoder's stochastic
depth where the config's ``drop_path`` is positive.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unidepth_tpu_torch.geometry.rays import generate_rays, spherical_zbuffer_to_euclidean
from unidepth_tpu_torch.models import stage_graphs
from unidepth_tpu_torch.models.backbones.convnext import CONVNEXT_PRESETS, LAYER_SCALE_INIT, ConvNeXt, ConvNeXtBlock
from unidepth_tpu_torch.models.backbones.dinov2 import VIT_PRESETS, DinoViT, ViTConfig
from unidepth_tpu_torch.models.serving import ServingPrecisionMixin
from unidepth_tpu_torch.models.unidepthv1.decoder import DecoderV1
from unidepth_tpu_torch.models.unidepthv2.model import compute_dtype, lecun_normal, resolve_device, trunc_normal
from unidepth_tpu_torch.nn.layers import LayerScale
from unidepth_tpu_torch.nn.upsample import CvnxtBlock
from unidepth_tpu_torch.ops.resize import resize
from unidepth_tpu_torch.utils import tracing
from unidepth_tpu_torch.utils.built_once import built_once
from unidepth_tpu_torch.utils.constants import IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD

V1_OUTPUT_IDX = {"vits14": (3, 6, 9, 12), "vitb14": (3, 6, 9, 12), "vitl14": (5, 12, 18, 24)}


def _v1_shapes(image_shape, network_shape):
    """The aspect-preserving size that fits ``image_shape`` into the network
    shape, and its scale."""
    h, w = image_shape
    if network_shape[1] / network_shape[0] > w / h:
        ratio = network_shape[0] / h
    else:
        ratio = network_shape[1] / w
    return (math.ceil(h * ratio - 0.5), math.ceil(w * ratio - 0.5)), ratio


def _v1_paddings(image_shape, network_shape):
    """(left, right, top, bottom) pads from ``image_shape`` to the network shape."""
    ch, cw = image_shape
    h, w = network_shape
    return (w - cw) // 2, w - cw - (w - cw) // 2, (h - ch) // 2, h - ch - (h - ch) // 2


@built_once()
def _input_scales(device: torch.device) -> tuple[torch.Tensor, ...]:
    """On ``device``: the divisors of a 0..255 image and of any other (255
    and 1), and the (2, 3) (shift, divisor) pairs of ImageNet's
    normalisation (its mean and std) and of none (0 and 1)."""
    return (torch.tensor(255.0, device=device), torch.tensor(1.0, device=device),
            torch.tensor([IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD], device=device),
            torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=device))


@built_once(maxsize=256)
def _k_maps(ratio: float, pl: int, pt: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The (3, 3) scale and shift that take a K to the network shape (K *
    scale + shift) and the pair that takes it back (K * scale - shift), for
    the resize ``ratio`` and the left and top pads, on ``device``."""
    inv = 1.0 / ratio
    return (
        torch.tensor([[ratio, 1.0, ratio], [1.0, ratio, ratio], [1.0, 1.0, 1.0]], device=device),
        torch.tensor([[0.0, 0.0, pl], [0.0, 0.0, pt], [0.0, 0.0, 0.0]], device=device),
        torch.tensor([[inv, 1.0, inv], [1.0, inv, inv], [1.0, 1.0, 1.0]], device=device),
        torch.tensor([[0.0, 0.0, pl * inv], [0.0, 0.0, pt * inv], [0.0, 0.0, 0.0]], device=device),
    )


def _encoder_widths(encoder: nn.Module) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The encoder's per-level feature widths and its cls token widths."""
    if isinstance(encoder, ConvNeXt):
        return tuple(encoder.cfg.dims), encoder.cfg.token_dims
    n = len(encoder.cfg.output_idx)
    return (encoder.cfg.embed_dim,) * n, (encoder.cfg.embed_dim,) * n


class UniDepthV1(ServingPrecisionMixin, nn.Module):
    """Encoder + V1 decoder with the reference checkpoint's state_dict keys
    (``pixel_encoder.*``, ``pixel_decoder.*``)."""

    # the exp depth head turns blanket int8 GEMM noise into a large depth
    # drift: int8 serves only the stages calibrate_int8_stages selects
    INT8_REQUIRES_CALIBRATION = True

    def __init__(
        self,
        encoder: nn.Module,
        hidden_dim: int = 512,
        decoder_depths: tuple[int, ...] = (3, 2, 1),
        num_heads: int = 8,
        expansion: int = 4,
        image_shape: tuple[int, int] = (462, 616),
    ):
        super().__init__()
        self.pixel_encoder = encoder
        input_dims, token_dims = _encoder_widths(encoder)
        self.pixel_decoder = DecoderV1(
            input_dims, token_dims, hidden_dim, num_heads=num_heads, expansion=expansion, depths=tuple(decoder_depths)
        )
        self.image_shape = tuple(image_shape)
        self._stage_graphs = stage_graphs.StageGraphs()
        self._init_serving()

    @classmethod
    def from_config(cls, config: dict, device=None, dtype: torch.dtype | None = None) -> "UniDepthV1":
        """Build from a reference-schema config dict, on ``device`` (default
        ``cuda``; without a card pass ``device="cpu"``) in ``dtype`` (default:
        bf16 on the card, fp32 on the CPU). An encoder name holding
        ``convnext`` builds ConvNeXt (its preset, ``depths``/``dims`` read
        from the config), any other DINOv2 from its preset, V1's output
        indices, ``use_norm`` off and the pos-embed offset 0.1; the ViT keys
        the V2 configs carry (``embed_dim``, ``depth``, ``num_heads``,
        ``pos_embed_size``, ``output_idx``) override the preset."""
        device = resolve_device(device)
        pe = config["model"]["pixel_encoder"]
        name = pe["name"]
        # the reference merges the training section into the encoder's
        # config, so drop_path comes from either
        drop_path = pe.get("drop_path", config.get("training", {}).get("drop_path", 0.0))
        if "convnext" in name:
            over = {k: tuple(pe[k]) for k in ("depths", "dims") if k in pe}
            encoder = ConvNeXt(dataclasses.replace(CONVNEXT_PRESETS[name], drop_path_rate=drop_path, **over))
        else:
            preset = name.replace("dinov2_", "")
            vit = VIT_PRESETS[preset]
            encoder = DinoViT(
                ViTConfig(
                    embed_dim=pe.get("embed_dim", vit.embed_dim),
                    depth=pe.get("depth", vit.depth),
                    num_heads=pe.get("num_heads", vit.num_heads),
                    pos_embed_size=pe.get("pos_embed_size", vit.pos_embed_size),
                    output_idx=tuple(pe.get("output_idx", V1_OUTPUT_IDX[preset])),
                    use_norm=False,
                    interpolate_offset=0.1,  # the reference builds the V1 encoder so
                    drop_path_rate=drop_path,
                ),
                stacking="max_cls",
            )
        dec = config["model"]["pixel_decoder"]
        model = cls(
            encoder,
            hidden_dim=dec["hidden_dim"],
            decoder_depths=tuple(dec.get("depths", (3, 2, 1))),
            num_heads=config["model"].get("num_heads", 8),
            expansion=config["model"].get("expansion", 4),
            image_shape=tuple(config.get("data", {}).get("image_shape", (462, 616))),
        )
        return model.to(device=device, dtype=dtype or compute_dtype(device))

    @classmethod
    def from_pretrained(cls, name_or_path, device=None, dtype: torch.dtype | None = None,
                        config: dict | None = None) -> "UniDepthV1":
        """Load a local checkpoint (``io.hub.load_checkpoint``: a directory
        or a weights file, the config from ``config``, a ``config.json`` or
        the shipped V1 config of the backbone the path names; reference
        checkpoint keys in any layout the loader normalises), placed as
        ``from_config`` places it (default ``cuda``)."""
        from unidepth_tpu_torch.io.hub import load_checkpoint

        device = resolve_device(device)  # before the checkpoint is read
        config, state_dict = load_checkpoint(name_or_path, version="1", config=config)
        model = cls.from_config(config, device=device, dtype=dtype)
        model.load_state_dict(model.select_checkpoint_keys(state_dict))
        return model

    def select_checkpoint_keys(self, state_dict: dict) -> dict:
        """Drop the reference checkpoint entries V1 has no use for: DINOv2's
        ``mask_token``, ``register_tokens`` and final ``norm`` (V1 runs with
        ``use_norm`` off), and timm ConvNeXt's ``norm_pre`` and ``head``.
        Everything else must match."""
        unused = tuple(f"pixel_encoder.{k}" for k in ("mask_token", "register_tokens", "norm.", "norm_pre.", "head."))
        return {k: v for k, v in state_dict.items() if not k.startswith(unused)}

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "UniDepthV1":
        """Random weights drawn on the CPU from ``torch.Generator(seed)`` with
        the JAX initializers' distributions: lecun-normal (truncated) dense
        and conv kernels, truncated normal 0.02 for the patch and position
        embeddings, normal 1.0 for the camera latents and level embeddings,
        layer scales at their init values (ConvNeXt's 1e-6), zero biases,
        cls token and GRN, unit LayerNorm scales. Where the model holds the
        ViT's linears below fp32, their fp32 draws are kept as the int8
        path's masters."""
        g = torch.Generator().manual_seed(seed)
        enc = self.pixel_encoder
        patch = enc.patch_embed.proj if isinstance(enc, DinoViT) else None
        drawn = {}  # linear -> its fp32 (weight, bias) draws
        for m in self.modules():
            if m is patch:
                m.weight.copy_(trunc_normal(m.weight.shape, 0.02, g))
                m.bias.zero_()
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                w = lecun_normal(m.weight.shape, m.weight[0].numel(), g)
                m.weight.copy_(w)
                m.bias.zero_()
                if isinstance(m, nn.Linear):
                    drawn[id(m)] = (w, torch.zeros(m.bias.shape))
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_value)
            elif isinstance(m, CvnxtBlock):
                m.gamma.fill_(1.0)
            elif isinstance(m, ConvNeXtBlock):
                if m.gamma is not None:
                    m.gamma.fill_(LAYER_SCALE_INIT)
                if m.mlp.grn is not None:
                    m.mlp.grn.weight.zero_()
                    m.mlp.grn.bias.zero_()
        if isinstance(enc, DinoViT):
            enc.cls_token.zero_()
            enc.pos_embed.copy_(trunc_normal(enc.pos_embed.shape, 0.02, g))
        dec = self.pixel_decoder
        for p in (dec.camera_layer.latents_pos, dec.level_embeds):
            p.copy_(torch.randn(p.shape, generator=g))
        self._set_fp32_masters({name: drawn[id(m)] for name, m in self._quantizable_linears().items()})
        return self

    def set_kernels(self, enabled: bool) -> "UniDepthV1":
        """``False`` pins every module to the kernels' plain PyTorch versions
        (the all-plain reference path); ``True`` (the default) lets CUDA
        tensors take the CUDA kernels."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = enabled
        self._reset_serving_caches()  # the graphs captured the kernels' launches
        return self

    def encode_decode(self, image, rays_gt=None, K_gt=None, skip_camera: bool = False,
                      generator: torch.Generator | None = None) -> dict:
        """The train and eval forward on a normalised batch (B, H, W, 3),
        moved to the model's device and dtype; ``generator`` turns on
        stochastic depth where the config has ``drop_path`` > 0 (training).
        Returns the mean of the three depth scales, each
        resized bilinearly (antialiased) to (H, W), and its points through
        the spherical z-buffer along the rays of the predicted K (or of
        ``K_gt`` with ``skip_camera``). Returns fp32 ``depth``, ``points``,
        ``rays`` and ``angles`` (channel-last), ``intrinsics`` and
        ``depth_features``."""
        p = next(self.parameters())
        _, h, w, _ = image.shape
        feats, cls_tokens = self.pixel_encoder(image.to(p.device, p.dtype), generator=generator)
        if rays_gt is not None:
            rays_gt = rays_gt.to(p.device)
        if K_gt is not None:
            K_gt = K_gt.to(p.device, torch.float32)
        K, preds, depth_features = self.pixel_decoder(feats, cls_tokens, (h, w), rays_gt=rays_gt,
                                                      skip_camera=skip_camera, K_gt=K_gt)
        pred = sum(resize(d, (h, w), mode="bilinear", align_corners=False, antialias=True) for d in preds) / len(preds)
        rays, angles = generate_rays(K, (h, w))
        angles = angles.reshape(-1, h, w, 2)
        pred = pred.float()
        return {
            "intrinsics": K,
            "depth": pred,
            "points": spherical_zbuffer_to_euclidean(torch.cat([angles, pred], dim=-1)),
            "rays": rays.reshape(-1, h, w, 3),
            "angles": angles,
            "depth_features": depth_features,
        }

    @torch.inference_mode()
    def infer(self, rgbs, intrinsics=None, skip_camera: bool = False) -> dict:
        """rgbs: (H,W,3) | (B,H,W,3) channel-last or (3,H,W) | (B,3,H,W)
        channel-first, numpy or torch. Values above 5 are taken as 0..255 and
        scaled, values in [0, 1] are ImageNet-normalised, anything else is
        taken as normalised already. intrinsics: optional (3,3) / (B,3,3) K,
        never written; with ``skip_camera`` it replaces the camera head.

        On a card the encoder and the decoder replay CUDA graphs captured per
        input shape (``models/stage_graphs.py``), and nothing in the call
        makes the host wait for the device: the value range is judged on the
        device, and the outputs are still being computed when it returns. A
        pinned ``rgbs`` is uploaded asynchronously, so it must not change
        until the outputs are read."""
        device = next(self.parameters()).device
        graphs = self._stage_graphs
        with tracing.span("unidepth.infer", device), stage_graphs.serving(graphs):
            with tracing.span("unidepth.infer.prepare", device):
                x, K_net, rays_gt, (H, W), ratio, pads = self._prepare(rgbs, intrinsics)
            nh, nw = self.image_shape
            with tracing.span("unidepth.infer.encoder", device):
                feats, cls_tokens = self._serving_encoder()(x)
            with tracing.span("unidepth.infer.decoder", device):
                K_pred, preds, _ = self.pixel_decoder(
                    feats, cls_tokens, (nh, nw), rays_gt=rays_gt, skip_camera=skip_camera and K_net is not None,
                    K_gt=K_net,
                )
            with tracing.span("unidepth.infer.postprocess", device):
                pl, pr, pt, pb = pads
                pred = sum(resize(d, (nh, nw), mode="bilinear", antialias=True) for d in preds) / len(preds)
                pred = resize(pred[:, pt : nh - pb, pl : nw - pr], (H, W), mode="bilinear", antialias=True)
                _, _, scale, shift = _k_maps(ratio, pl, pt, device)
                K_out = K_pred * scale - shift
                # with a given K the reference back-projects the original grid
                # through the network-scaled K
                _, angles = generate_rays(K_out if K_net is None else K_net, (H, W))
                points = spherical_zbuffer_to_euclidean(torch.cat([angles.reshape(-1, H, W, 2), pred], dim=-1))
                return graphs.detach({"intrinsics": K_out, "points": points, "depth": pred})

    def _reset_serving_caches(self):
        super()._reset_serving_caches()
        self._stage_graphs.clear()  # captured over the weights, kernels and encoder these change

    def _prepare(self, rgbs, intrinsics):
        """``infer``'s input on the model's device: the image uploaded,
        scaled by its value range, resized and padded into the network shape
        in the model's dtype; a given K at the network shape and its rays
        there (or None); the input's (H, W), the resize ratio and the
        pads."""
        p = next(self.parameters())
        device, dtype = p.device, p.dtype
        rgb = torch.as_tensor(np.asarray(rgbs) if not torch.is_tensor(rgbs) else rgbs)
        if rgb.ndim == 3:
            rgb = rgb[None]
        if rgb.shape[1] == 3 and rgb.shape[-1] != 3:
            rgb = rgb.permute(0, 2, 3, 1)
        # convert after the copy: uint8 moves 4x fewer bytes
        rgb = rgb.to(device, non_blocking=rgb.device.type == "cpu" and rgb.is_pinned()).float()
        B, H, W, _ = rgb.shape
        # the value range, judged on the device: above 5 it is 0..255, scaled
        # and normalised; within [0, 1] normalised; otherwise as given
        mn, mx = torch.aminmax(rgb)
        wide = mx > 5.0
        normalize = wide | ((mn >= 0.0) & (mx <= 1.0))
        c255, c1, imagenet, identity = _input_scales(device)
        sub, div = torch.where(normalize, imagenet, identity)
        x = (rgb / torch.where(wide, c255, c1) - sub) / div

        K = None
        if intrinsics is not None:
            K = torch.as_tensor(np.asarray(intrinsics) if not torch.is_tensor(intrinsics) else intrinsics)
            K = K.to(torch.float32)
            if K.device.type == "cpu" and device.type == "cuda":  # uploaded without a host wait
                K = K.pin_memory()
            K = K.to(device, non_blocking=K.is_pinned())
            K = (K[None] if K.ndim == 2 else K).expand(B, 3, 3)

        (sh, sw), ratio = _v1_shapes((H, W), self.image_shape)
        pads = _v1_paddings((sh, sw), self.image_shape)
        pl, pr, pt, pb = pads
        x = resize(x, (sh, sw), mode="bilinear", align_corners=False, antialias=True)
        if any(pads):
            x = F.pad(x, (0, 0, pl, pr, pt, pb))

        K_net = rays_gt = None
        if K is not None:  # K at the network shape; the caller's tensor is not written
            scale, shift, _, _ = _k_maps(ratio, pl, pt, device)
            K_net = K * scale + shift
            rays_gt = generate_rays(K_net, self.image_shape)[0]
        return x.to(dtype), K_net, rays_gt, (H, W), ratio, pads

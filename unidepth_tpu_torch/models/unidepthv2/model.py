"""UniDepthV2 (counterpart of unidepth_tpu/models/unidepthv2/model.py).

``infer(rgb, camera)`` runs eagerly: ImageNet normalisation, aspect-ratio
padding and a bilinear resize into the pixel budget, the DINOv2 encoder, the
V2 decoder, then the maps resized back to the input, pads stripped and the
intrinsics de-scaled. Outputs are channel-last float32, as in the JAX
package.

Compute dtype is the parameters' dtype: ``from_config`` puts the model in
bf16 on CUDA and float32 on the CPU (the JAX package's rule), and the JAX
serving pre-cast of the parameters is ``module.to(dtype)`` here.
``set_serving_precision('int8')`` (``models/serving.py``) makes ``infer()``
run the encoder with int8 GEMMs, quantized from fp32 weights.
``encode_decode`` is the differentiable train forward on a normalised batch
(the encoder checkpointed block by block, no serving cache, no
``inference_mode``); ``get_params_info`` gives the optimizer's groups. The
``attention_logit_bound`` config key is read and kept; it selects nothing,
because the port's attention kernels keep the row max.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from unidepth_tpu_torch.geometry.cameras import CameraBase, Pinhole
from unidepth_tpu_torch.models.backbones.dinov2 import VIT_PRESETS, DinoViT, ViTConfig
from unidepth_tpu_torch.models.serving import ServingPrecisionMixin
from unidepth_tpu_torch.models.unidepthv2.decoder import Decoder
from unidepth_tpu_torch.nn.layers import LayerScale
from unidepth_tpu_torch.nn.upsample import ResidualConvUnit
from unidepth_tpu_torch.ops.quant import quantizable_linears
from unidepth_tpu_torch.ops.resize import resize
from unidepth_tpu_torch.utils.constants import IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD


def get_paddings(shape: tuple[int, int], ratio_bounds: tuple[float, float]):
    """Pad (H, W) into the aspect-ratio interval; returns (l, r, t, b) and
    the padded (H, W). An in-bounds ratio is never padded (no negative pad)."""
    h, w = shape
    ratio = w / h
    if ratio_bounds[0] <= ratio <= ratio_bounds[1]:
        return (0, 0, 0, 0), (h, w)
    if ratio > ratio_bounds[1]:  # too wide: pad vertically
        new_h = max(h, math.ceil(w / ratio_bounds[1]))
        pt = (new_h - h) // 2
        return (0, 0, pt, new_h - h - pt), (new_h, w)
    new_w = max(w, math.ceil(h * ratio_bounds[0]))
    pl = (new_w - w) // 2
    return (pl, new_w - w - pl, 0, 0), (h, new_w)


def get_resize_factor(shape: tuple[int, int], pixels_bounds: tuple[float, float], multiple: int = 14):
    """Resize factor into the pixel budget; the shape rounds up to ``multiple``."""
    h, w = shape
    n = h * w
    target = min(pixels_bounds[1], max(pixels_bounds[0], n))
    factor = (target / n) ** 0.5
    new_h = math.ceil(int(h * factor) / multiple) * multiple
    new_w = math.ceil(int(w * factor) / multiple) * multiple
    return factor, (new_h, new_w)


DEFAULT_SHAPE_CONSTRAINTS = {
    "ratio_bounds": (0.5, 2.5),
    "pixels_min": 200_000,
    "pixels_max": 600_000,
    "shape_mult": 14,
}


def compute_dtype(device) -> torch.dtype:
    """bf16 on CUDA, float32 elsewhere."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def resolve_device(device) -> torch.device:
    """``device`` as given, else the card. Without a card an unnamed device
    raises: the CPU runs only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available and no device was named; "
            'pass device="cpu" to build the model on the CPU'
        )
    return torch.device("cuda")


def trunc_normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    """``std`` times a [-2, 2]-truncated standard normal, drawn from ``g``."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    return t * std


def lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: variance 1/fan_in of a [-2, 2]-truncated normal."""
    return trunc_normal(shape, math.sqrt(1.0 / fan_in) / 0.87962566103423978, g)


class UniDepthV2(ServingPrecisionMixin, nn.Module):
    """Encoder + decoder with the reference checkpoint's state_dict keys
    (``pixel_encoder.*``, ``pixel_decoder.*``)."""

    INFER_OUTPUTS = ("depth", "points", "rays", "confidence", "radius", "intrinsics", "depth_features")

    def __init__(
        self,
        encoder_cfg: ViTConfig,
        hidden_dim: int,
        out_dim: int,
        decoder_depths: tuple[int, ...] = (2, 2, 2),
        num_heads: int = 8,
        expansion: int = 4,
        layer_scale: float = 1.0,
        shape_constraints: dict | None = None,
        stacking: str = "last",
    ):
        super().__init__()
        self.encoder_cfg = encoder_cfg
        self.pixel_encoder = DinoViT(encoder_cfg, stacking=stacking)
        self.pixel_decoder = Decoder(
            input_dims=(encoder_cfg.embed_dim,) * len(encoder_cfg.output_idx),
            hidden_dim=hidden_dim,
            num_heads=num_heads,
            expansion=expansion,
            depths=tuple(decoder_depths),
            out_dim=out_dim,
            layer_scale=layer_scale,
        )
        self.shape_constraints = {**DEFAULT_SHAPE_CONSTRAINTS, **(shape_constraints or {})}
        self.resolution_level: int | None = None
        self.interpolation_mode = "bilinear"
        self.attention_logit_bound = None
        self._init_serving()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, config: dict, device=None, dtype: torch.dtype | None = None) -> "UniDepthV2":
        """Build from a reference-schema JSON config dict, placed on
        ``device`` (default ``cuda``; without a card pass ``device="cpu"``)
        in ``dtype`` (default ``compute_dtype``: bf16 on the card, fp32 on
        the CPU)."""
        device = resolve_device(device)
        pe = config["model"]["pixel_encoder"]
        vit = VIT_PRESETS.get(pe["name"].replace("dinov2_", ""))
        enc_cfg = ViTConfig(
            embed_dim=pe.get("embed_dim", vit.embed_dim if vit else 384),
            depth=pe.get("depth", vit.depth if vit else 12),
            num_heads=pe.get("num_heads", vit.num_heads if vit else 6),
            pos_embed_size=pe.get("pos_embed_size", 37),
            output_idx=tuple(pe.get("output_idx", vit.output_idx if vit else (3, 6, 9, 12))),
            num_register_tokens=pe.get("num_register_tokens", 0),
            use_norm=pe.get("use_norm", False),
            # the reference merges the training section into the encoder's
            # config, so drop_path comes from either
            drop_path_rate=pe.get("drop_path", config.get("training", {}).get("drop_path", 0.0)),
        )
        sc = config.get("data", {}).get("augmentations", {}).get("shape_constraints")
        shape_constraints = None
        if sc:
            shape_constraints = {
                "ratio_bounds": tuple(sc["ratio_bounds"]),
                "pixels_min": sc["pixels_min"],
                "pixels_max": sc["pixels_max"],
                "shape_mult": sc.get("shape_mult", 14),
            }
        dec = config["model"]["pixel_decoder"]
        model = cls(
            encoder_cfg=enc_cfg,
            hidden_dim=dec["hidden_dim"],
            out_dim=dec["out_dim"],
            decoder_depths=tuple(dec.get("depths", (2, 2, 2))),
            num_heads=config["model"].get("num_heads", 8),
            expansion=config["model"].get("expansion", 4),
            layer_scale=config["model"].get("layer_scale", 1.0),
            shape_constraints=shape_constraints,
            stacking=pe.get("stacking_fn", "last"),
        )
        model.attention_logit_bound = config["model"].get("attention_logit_bound")
        return model.to(device=device, dtype=dtype or compute_dtype(device))

    @classmethod
    def from_pretrained(cls, name_or_path, device=None, dtype: torch.dtype | None = None,
                        config: dict | None = None) -> "UniDepthV2":
        """Load a local checkpoint (``io.hub.load_checkpoint``: a directory
        or a weights file, the config from ``config``, a ``config.json`` or
        the shipped V2 config of the backbone the path names; reference
        checkpoint keys in any layout the loader normalises), placed as
        ``from_config`` places it (default ``cuda``)."""
        from unidepth_tpu_torch.io.hub import load_checkpoint

        device = resolve_device(device)  # before the checkpoint is read
        config, state_dict = load_checkpoint(name_or_path, version="2", config=config)
        model = cls.from_config(config, device=device, dtype=dtype)
        model.load_state_dict(model.select_checkpoint_keys(state_dict))
        return model

    def select_checkpoint_keys(self, state_dict: dict) -> dict:
        """Drop the reference checkpoint entries this model has no use for:
        DINOv2's ``mask_token``, its dormant ``register_tokens`` and, with
        ``use_norm`` off, the final ``norm``. Everything else must match."""
        unused = ("pixel_encoder.mask_token", "pixel_encoder.register_tokens")
        if not self.encoder_cfg.use_norm:
            unused += ("pixel_encoder.norm.",)
        return {k: v for k, v in state_dict.items() if not k.startswith(unused)}

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "UniDepthV2":
        """Random weights drawn on the CPU from ``torch.Generator(seed)`` with
        the JAX initializers' distributions: lecun-normal (truncated) dense
        and conv kernels, truncated normal 0.02 for the patch embedding,
        position embedding and ConvTranspose kernels, normal 1.0 for the
        camera latents, orthogonal level embeddings, LayerScale at its init
        value, zero biases and cls token, unit LayerNorm scales. Where the
        model holds the encoder linears below fp32, their fp32 draws are kept
        as the int8 path's masters."""
        g = torch.Generator().manual_seed(seed)
        drawn = {}

        def trunc(shape, std):
            return trunc_normal(shape, std, g)

        def lecun(shape, fan_in):
            return lecun_normal(shape, fan_in, g)

        def put(p, value):
            p.copy_(value)
            drawn[id(p)] = value

        enc = self.pixel_encoder
        for m in self.modules():
            if m is enc.patch_embed.proj or isinstance(m, nn.ConvTranspose2d):
                put(m.weight, trunc(m.weight.shape, 0.02))
                put(m.bias, torch.zeros(m.bias.shape))
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                put(m.weight, lecun(m.weight.shape, m.weight[0].numel()))
                if m.bias is not None:
                    put(m.bias, torch.zeros(m.bias.shape))
            elif isinstance(m, nn.LayerNorm):
                put(m.weight, torch.ones(m.weight.shape))
                put(m.bias, torch.zeros(m.bias.shape))
            elif isinstance(m, LayerScale):
                m.gamma.fill_(m.init_value)
            elif isinstance(m, ResidualConvUnit) and m.gamma is not None:
                m.gamma.fill_(m.layer_scale)
        put(enc.cls_token, torch.zeros(enc.cls_token.shape))
        put(enc.pos_embed, trunc(enc.pos_embed.shape, 0.02))
        cam = self.pixel_decoder.camera_layer
        put(cam.latents_pos, torch.randn(cam.latents_pos.shape, generator=g))
        le = self.pixel_decoder.level_embeds
        put(le, nn.init.orthogonal_(torch.empty(le.shape[-2:]), generator=g).reshape(le.shape))
        self._set_fp32_masters(
            {name: (drawn[id(m.weight)], drawn[id(m.bias)]) for name, m in quantizable_linears(enc).items()}
        )
        return self

    def set_kernels(self, enabled: bool) -> "UniDepthV2":
        """``False`` pins every module to the kernels' plain PyTorch versions
        (the all-plain reference path); ``True`` (the default) lets CUDA
        tensors take the CUDA kernels."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = enabled
        self._reset_serving_caches()  # the int8 encoder copies its blocks' flag
        return self

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def _pixels_bounds(self) -> tuple[float, float]:
        lo = self.shape_constraints["pixels_min"]
        hi = self.shape_constraints["pixels_max"]
        if self.resolution_level is not None:
            level = self.resolution_level
            if not (0 <= level < 10):
                raise ValueError("resolution_level should be in [0, 10)")
            interval = (hi - lo) / 10
            return (level * interval + lo, (level + 1) * interval + lo)
        warnings.warn("resolution_level not set, using default pixel bounds")
        return (lo, hi)

    def serving_shape_key(self, image_hw, has_camera: bool = False, normalize: bool = True, outputs=None):
        """(H, W, pads, padded_hw, network_hw, factor, has_camera, normalize,
        outputs) for an input shape: the shape arithmetic ``infer`` uses."""
        H, W = image_hw
        pads, padded = get_paddings((H, W), self.shape_constraints["ratio_bounds"])
        factor, new_hw = get_resize_factor(padded, self._pixels_bounds(), self.shape_constraints["shape_mult"])
        out_key = None
        if outputs is not None:
            bad = set(outputs) - set(self.INFER_OUTPUTS)
            if bad:
                raise ValueError(f"unknown infer outputs {sorted(bad)}; valid: {self.INFER_OUTPUTS}")
            out_key = tuple(sorted(set(outputs)))
        return (H, W, pads, padded, new_hw, factor, has_camera, normalize, out_key)

    @torch.inference_mode()
    def infer(self, rgb, camera=None, normalize: bool = True, outputs=None) -> dict:
        """rgb: (H,W,3) | (B,H,W,3) channel-last or (3,H,W) | (B,3,H,W)
        channel-first, uint8 or float, numpy or torch. camera: any camera
        of ``geometry.cameras`` (a ``BatchCamera`` mixes models), or a (3,3)
        / (B,3,3) K matrix; a one-camera batch is broadcast to B. Returns
        channel-last float32 outputs at the input resolution; ``outputs``
        selects a subset of INFER_OUTPUTS (leaving out 'confidence' skips
        the confidence head)."""
        p = next(self.parameters())
        device, dtype = p.device, p.dtype
        rgb = torch.as_tensor(np.asarray(rgb) if not torch.is_tensor(rgb) else rgb)
        if rgb.ndim == 3:
            rgb = rgb[None]
        if rgb.shape[1] == 3 and rgb.shape[-1] != 3:
            rgb = rgb.permute(0, 2, 3, 1)
        rgb = rgb.to(device).float()  # convert after the copy: uint8 moves 4x fewer bytes
        B, H, W, _ = rgb.shape
        if camera is not None:
            if not isinstance(camera, CameraBase):
                camera = Pinhole.from_K(torch.as_tensor(camera if torch.is_tensor(camera) else np.asarray(camera)))
            camera = camera.to(device)
            if camera.batch == 1 and B > 1:
                camera = camera.expand(B)

        key = self.serving_shape_key((H, W), camera is not None, normalize, outputs)
        _, _, pads, padded, (new_h, new_w), factor, _, _, out_key = key
        pl, pr, pt, pb = pads
        x = rgb
        if normalize:
            mean = torch.tensor(IMAGENET_DATASET_MEAN, device=device) * 255.0
            std = torch.tensor(IMAGENET_DATASET_STD, device=device) * 255.0
            x = (x - mean) / std
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        x = resize(x, (new_h, new_w), mode="bilinear", align_corners=False)

        rays_gt = None
        if camera is not None:
            cam = camera.crop(-pl, -pt).resize(factor)
            rays_gt = cam.get_rays(new_h, new_w, eps=1e-4).reshape(B, new_h * new_w, 3)

        feats, cls_tokens = self._serving_encoder()(x.to(dtype))
        want_conf = out_key is None or "confidence" in out_key
        out = self.pixel_decoder(feats, cls_tokens, (new_h, new_w), rays_gt=rays_gt, confidence=want_conf)
        rays = out["rays"].reshape(-1, new_h, new_w, 3).float()
        core = {
            "points": rays * out["radius"],
            "rays": rays,
            "confidence": out.get("confidence"),
            "intrinsics": out["intrinsics"],
            "depth_features": out["depth_features"],
        }
        return self._postprocess(core, pads, padded, factor, out_key)

    def encode_decode(self, image, rays_gt=None, generator: torch.Generator | None = None) -> dict:
        """The train forward on a normalised batch (B, H, W, 3), H and W
        multiples of 14, moved to the model's device and dtype. Returns the
        decoder's outputs plus 'points' and 'depth' (fp32, channel-last).
        ``rays_gt`` (B, H*W, 3) replaces the predicted rays in the depth
        head; ``generator`` turns on stochastic depth where the config has
        ``drop_path`` > 0."""
        p = next(self.parameters())
        _, h, w, _ = image.shape
        feats, cls_tokens = self.pixel_encoder(image.to(p.device, p.dtype), generator=generator)
        if rays_gt is not None:
            rays_gt = rays_gt.to(p.device)
        out = self.pixel_decoder(feats, cls_tokens, (h, w), rays_gt=rays_gt)
        rays = out["rays"].reshape(-1, h, w, 3).float()
        out["points"] = rays * out["radius"]
        out["depth"] = out["points"][..., 2:3]
        return out

    def _postprocess(self, core, pads, padded, factor, outputs=None):
        """Resize network-resolution maps back to the padded input grid, strip
        the pads, renormalise the rays and de-scale the intrinsics."""
        pl, pr, pt, pb = pads
        ph, pw = padded

        def post(t):
            t = resize(t, (ph, pw), mode=self.interpolation_mode, align_corners=False)
            return t[:, pt : ph - pb, pl : pw - pr]

        points = post(core["points"])
        rays = post(core["rays"])
        rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True).clamp_min(1e-5)
        inv = 1.0 / factor
        scale_mat = torch.tensor(
            [[inv, 1.0, inv], [1.0, inv, inv], [1.0, 1.0, 1.0]], device=core["intrinsics"].device
        )
        K = core["intrinsics"] * scale_mat  # fx, fy, cx, cy de-scaled
        K[:, 0, 2] -= pl
        K[:, 1, 2] -= pt
        res = {
            "depth": points[..., 2:3],
            "points": points,
            "rays": rays,
            "radius": torch.linalg.norm(points, dim=-1, keepdim=True),
            "intrinsics": K,
            "depth_features": core["depth_features"],
        }
        if core["confidence"] is not None:
            res["confidence"] = post(core["confidence"])
        if outputs is not None:
            res = {k: res[k] for k in outputs}
        return res


def get_params_info(model: UniDepthV2, config: dict):
    """The optimizer's groups (the JAX ``get_params_info``): per parameter
    name, the lr multiplier and the weight-decay flag of
    ``training.optim``."""
    from unidepth_tpu_torch.training.optim import lr_scale_tree, wd_mask_tree

    tr = config.get("training", {})
    enc_lr = config["model"]["pixel_encoder"].get("lr", 2e-6)
    params = dict(model.named_parameters())
    scales = lr_scale_tree(params, enc_lr / tr.get("lr", 1e-4), tr.get("ld", 1.0), model.encoder_cfg.depth)
    return scales, wd_mask_tree(params)

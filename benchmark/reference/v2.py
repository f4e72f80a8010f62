"""Plain float32 reference of UniDepthV2 serving: ``infer(rgb)`` with its
default outputs, from uint8 images to depth, confidence and intrinsics at the
input resolution.

Frozen at commit 9a9bd4f from the port's plain equations in
``unidepth_tpu_torch/models/unidepthv2/model.py`` (``infer``,
``_postprocess``, ``get_paddings``, ``get_resize_factor``),
``models/unidepthv2/decoder.py``, ``models/backbones/dinov2.py`` (stacking
'last'), ``nn/layers.py`` (``AttentionBlock``, ``MLP``), ``nn/upsample.py``
(``ResidualConvUnit``, ``ResUpsampleBil``), ``ops/fourier.py`` and
``ops/flash_attention.py`` (the plain attention). It imports torch and this
folder only; the weights come as a dict of float32 tensors under the
reference checkpoint's names.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .ops import IMAGENET_MEAN, IMAGENET_STD, Numerics, flat_interpolate, layer_norm, merge_heads, rays_from_K
from .ops import resize, split_heads

VIT_PRESETS = {"vits14": (384, 12, 6), "vitb14": (768, 12, 12), "vitl14": (1024, 24, 16)}
PATCH = 14


def model_sizes(config: dict) -> dict:
    """The sizes the forward needs, read from a reference-schema config."""
    pe = config["model"]["pixel_encoder"]
    dim, depth, heads = VIT_PRESETS[pe["name"].replace("dinov2_", "")]
    dec = config["model"]["pixel_decoder"]
    sc = config["data"]["augmentations"]["shape_constraints"]
    return {
        "embed_dim": pe.get("embed_dim", dim),
        "depth": pe.get("depth", depth),
        "heads": pe.get("num_heads", heads),
        "pos_embed_size": pe.get("pos_embed_size", 37),
        "output_idx": tuple(pe["output_idx"]),
        "use_norm": pe.get("use_norm", False),
        "hidden": dec["hidden_dim"],
        "decoder_heads": config["model"].get("num_heads", 8),
        "ratio_bounds": tuple(sc["ratio_bounds"]),
        "pixels_bounds": (sc["pixels_min"], sc["pixels_max"]),
        "shape_mult": sc.get("shape_mult", 14),
    }


def paddings(shape, ratio_bounds):
    """(l, r, t, b) pads into the aspect-ratio interval, and the padded (H, W)."""
    h, w = shape
    ratio = w / h
    if ratio_bounds[0] <= ratio <= ratio_bounds[1]:
        return (0, 0, 0, 0), (h, w)
    if ratio > ratio_bounds[1]:
        new_h = max(h, math.ceil(w / ratio_bounds[1]))
        pt = (new_h - h) // 2
        return (0, 0, pt, new_h - h - pt), (new_h, w)
    new_w = max(w, math.ceil(h * ratio_bounds[0]))
    pl = (new_w - w) // 2
    return (pl, new_w - w - pl, 0, 0), (h, new_w)


def resize_factor(shape, pixels_bounds, multiple):
    """The factor into the pixel budget and the network shape, rounded up
    to ``multiple``."""
    h, w = shape
    n = h * w
    target = min(pixels_bounds[1], max(pixels_bounds[0], n))
    factor = (target / n) ** 0.5
    return factor, (math.ceil(int(h * factor) / multiple) * multiple, math.ceil(int(w * factor) / multiple) * multiple)


def network_shape(config: dict, image_hw) -> tuple[int, int]:
    s = model_sizes(config)
    _, padded = paddings(tuple(image_hw), s["ratio_bounds"])
    return resize_factor(padded, s["pixels_bounds"], s["shape_mult"])[1]


def mlp(nx: Numerics, p, pre, x):
    y = nx.linear(layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"], 1e-5), p[pre + "proj1.weight"],
                  p[pre + "proj1.bias"])
    return nx.linear(F.gelu(y), p[pre + "proj2.weight"], p[pre + "proj2.bias"])


def attention_block(nx: Numerics, p, pre, x, heads, context=None, pos=None, pos_context=None):
    """Pre-LN (cross-)attention block (eps 1e-5) with optional LayerScales."""
    context = x if context is None else context
    y = layer_norm(x, p[pre + "norm_attnx.weight"], p[pre + "norm_attnx.bias"], 1e-5)
    c = layer_norm(context, p[pre + "norm_attnctx.weight"], p[pre + "norm_attnctx.bias"], 1e-5)
    k, v = nx.linear(c, p[pre + "kv.weight"], p.get(pre + "kv.bias")).chunk(2, dim=-1)
    q = split_heads(nx.linear(y, p[pre + "q.weight"], p.get(pre + "q.bias")), heads)
    k, v = split_heads(k, heads), split_heads(v, heads)
    if pos is not None:
        q = q + split_heads(pos, heads)
    if pos_context is not None:
        k = k + split_heads(pos_context, heads)
    a = nx.linear(merge_heads(nx.attention(q, k, v)), p[pre + "out.weight"], p.get(pre + "out.bias"))
    if pre + "ls1.gamma" in p:
        a = a * p[pre + "ls1.gamma"]
    x = x + a
    m = mlp(nx, p, pre + "mlp.", x)
    if pre + "ls2.gamma" in p:
        m = m * p[pre + "ls2.gamma"]
    return x + m


def encoder(nx: Numerics, p, s, image):
    """DINOv2 on (B, H, W, 3) normalised images: per output index, the
    normed patch features (B, h, w, C) and cls token (B, 1, C)."""
    pre = "pixel_encoder."
    b, h, w, _ = image.shape
    gh, gw, c, heads = h // PATCH, w // PATCH, s["embed_dim"], s["heads"]
    x = nx.conv2d(image.permute(0, 3, 1, 2), p[pre + "patch_embed.proj.weight"], p[pre + "patch_embed.proj.bias"],
                  stride=PATCH)
    x = x.flatten(2).transpose(1, 2)
    pos = p[pre + "pos_embed"]
    size = s["pos_embed_size"]
    patch_pos = resize(pos[:, 1:].reshape(1, size, size, c), (gh, gw), mode="bicubic")
    x = x + patch_pos.reshape(1, gh * gw, c)
    x = torch.cat([(p[pre + "cls_token"] + pos[:, :1]).expand(b, 1, c), x], dim=1)
    feats, cls_tokens = [], []
    for i in range(s["depth"]):
        bp = f"{pre}blocks.{i}."
        y = layer_norm(x, p[bp + "norm1.weight"], p[bp + "norm1.bias"], 1e-6)
        q, k, v = nx.linear(y, p[bp + "attn.qkv.weight"], p[bp + "attn.qkv.bias"]).reshape(
            b, -1, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        a = nx.linear(merge_heads(nx.attention(q, k, v)), p[bp + "attn.proj.weight"], p[bp + "attn.proj.bias"])
        x = x + a * p[bp + "ls1.gamma"]
        y = nx.ln_linear_gelu(x, p[bp + "norm2.weight"], p[bp + "norm2.bias"], 1e-6, p[bp + "mlp.fc1.weight"],
                              p[bp + "mlp.fc1.bias"])
        x = x + nx.linear(y, p[bp + "mlp.fc2.weight"], p[bp + "mlp.fc2.bias"]) * p[bp + "ls2.gamma"]
        if i + 1 in s["output_idx"]:
            out = layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"], 1e-6) if s["use_norm"] else x
            cls_tokens.append(out[:, :1])
            feats.append(out[:, 1:].reshape(b, gh, gw, c))
    return feats, cls_tokens


def fourier_features(x, dim, max_freq):
    """Log-spaced sin features of (..., 2) angles -> (..., dim); the sines in
    float64, rounded once."""
    bands = dim // x.shape[-1]
    scales = torch.as_tensor(2.0 ** np.linspace(0.0, math.log2(max_freq), num=bands) * math.pi, dtype=x.dtype,
                             device=x.device)
    return torch.sin((x[..., None] * scales).double()).float().reshape(*x.shape[:-1], -1)


def camera_head(nx: Numerics, p, s, tokens, hw):
    pre = "pixel_decoder.camera_layer."
    pos = p[pre + "latents_pos"].expand(tokens.shape[0], -1, -1)
    x = mlp(nx, p, pre + "project.", tokens)
    x = attention_block(nx, p, pre + "aggregate1.", x, s["decoder_heads"], pos=pos)
    x = attention_block(nx, p, pre + "aggregate2.", x, s["decoder_heads"], pos=pos)
    x = mlp(nx, p, pre + "out_pinhole.", x)[..., 0]
    h, w = hw
    diag = math.sqrt(h * h + w * w)
    fx, fy = torch.exp(x[:, 0]) * (0.7 * diag), torch.exp(x[:, 1]) * (0.7 * diag)
    cx, cy = torch.sigmoid(x[:, 2]) * w, torch.sigmoid(x[:, 3]) * h
    K = torch.zeros(x.shape[0], 3, 3, device=x.device)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = fx, fy, cx, cy, 1.0
    return K


def conv_unit(nx: Numerics, p, pre, x):
    out = nx.conv2d(F.leaky_relu(x, 0.01), p[pre + "conv1.weight"], p[pre + "conv1.bias"], padding=1)
    out = nx.conv2d(F.leaky_relu(out, 0.01), p[pre + "conv2.weight"], p[pre + "conv2.bias"], padding=1)
    return out * p[pre + "gamma"] + x


def head(nx: Numerics, p, mlp_pre, lr_pre, hr_pre, latents, out_hw):
    """LN -> Linear, a reflect 3x3 conv, an align-corners resize to the
    network shape, a reflect 3x3 conv, LeakyReLU and a 1x1 conv."""
    y = layer_norm(latents.permute(0, 2, 3, 1), p[mlp_pre + "0.weight"], p[mlp_pre + "0.bias"], 1e-5)
    y = nx.linear(y, p[mlp_pre + "1.weight"], p[mlp_pre + "1.bias"]).permute(0, 3, 1, 2)
    y = nx.conv2d(y, p[lr_pre + "weight"], p[lr_pre + "bias"], padding=1, padding_mode="reflect")
    y = resize(y, out_hw, align_corners=True, channel_last=False)
    y = nx.conv2d(y, p[hr_pre + "0.weight"], p[hr_pre + "0.bias"], padding=1, padding_mode="reflect")
    return nx.conv2d(F.leaky_relu(y, 0.01), p[hr_pre + "2.weight"], p[hr_pre + "2.bias"])


def decoder(nx: Numerics, p, s, feats, cls_tokens, hw, K_given=None):
    """The V2 decoder: intrinsics (B, 3, 3), rays (B, H*W, 3), radius and
    confidence (B, H, W, 1) at the network shape ``hw``. With ``K_given``
    (B, 3, 3) at the network shape, its rays condition the depth head in
    place of the camera head's own (whose K is still returned)."""
    pre = "pixel_decoder."
    H, W = hw
    b, gh, gw, _ = feats[0].shape
    n = gh * gw
    tokens = [nx.linear(f.reshape(b, n, -1), p[f"{pre}input_adapter.input_adapters.{i}.weight"],
                        p[f"{pre}input_adapter.input_adapters.{i}.bias"]) for i, f in enumerate(feats)]
    cams = [nx.linear(t, p[f"{pre}camera_token_adapter.input_adapters.{i}.weight"],
                      p[f"{pre}camera_token_adapter.input_adapters.{i}.bias"]) for i, t in enumerate(cls_tokens)]
    K = camera_head(nx, p, s, torch.cat(cams, dim=1), hw)
    rays = rays_from_K(K if K_given is None else K_given, H, W, 1e-5)

    dp = pre + "depth_layer."
    r = flat_interpolate(rays, hw, (gh, gw), antialias=True)
    r = r / torch.linalg.norm(r, dim=-1, keepdim=True).clamp_min(1e-4)
    x, y, z = r.unbind(-1)
    polar = torch.arccos(z.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    azimuth = torch.atan2(y, x.abs().clamp_min(1e-3) * torch.where(x >= 0, 1.0, -1.0))
    rays_embedding = fourier_features(torch.stack([polar, azimuth], dim=-1), s["hidden"], max(gh, gw) // 2)
    heads = s["decoder_heads"]
    cond = [attention_block(nx, p, f"{dp}prompt_camera.{i}.layers.0.", t, heads, context=rays_embedding)
            for i, t in enumerate(tokens)]
    init_latents = nx.linear(cond[0], p[dp + "to_latents.weight"], p[dp + "to_latents.bias"])

    def nchw(t):
        return t.reshape(b, gh, gw, -1).permute(0, 3, 1, 2)

    latents = nchw(init_latents)
    for i in range(len(cond) - 1):
        up = f"{dp}ups.{i}."
        latents = latents + nx.conv_transpose_patch(nchw(cond[i + 1]), p[f"{dp}process_features.{i}.weight"],
                                                    p[f"{dp}process_features.{i}.bias"])
        j = 0
        while f"{up}convs.{j}.conv1.weight" in p:
            latents = conv_unit(nx, p, f"{up}convs.{j}.", latents)
            j += 1
        latents = nx.conv2d(latents, p[up + "up.0.weight"], p[up + "up.0.bias"])
        latents = resize(latents, (2 * latents.shape[-2], 2 * latents.shape[-1]), channel_last=False)
    last = len(cond) - 2
    logdepth = head(nx, p, f"{dp}depth_mlp.{last}.", dp + "to_depth_lr.", dp + "to_depth_hr.", latents, hw)
    logconf = head(nx, p, dp + "confidence_mlp.", dp + "to_confidence_lr.", dp + "to_confidence_hr.", latents, hw)
    radius = torch.exp(logdepth.clamp(-8.0, 8.0) + 2.0).permute(0, 2, 3, 1)
    confidence = torch.exp(logconf.clamp(-8.0, 8.0)).permute(0, 2, 3, 1)
    return K, rays, radius, confidence


def infer(nx: Numerics, p: dict, config: dict, rgb: torch.Tensor, intrinsics=None) -> dict:
    """rgb: (B, H, W, 3) uint8 on the device. Returns float32 ``depth`` and
    ``confidence`` (B, H, W, 1) and ``intrinsics`` (B, 3, 3) at the input
    resolution. ``intrinsics`` (B, 3, 3) at the input resolution, when
    given, are the camera the depth head is conditioned on (the served
    model's own, to judge its depth given its camera); the returned
    intrinsics are always the reference's own."""
    s = model_sizes(config)
    x = rgb.float()
    B, H, W, _ = x.shape
    (pl, pr, pt, pb), (ph, pw) = paddings((H, W), s["ratio_bounds"])
    factor, (nh, nw) = resize_factor((ph, pw), s["pixels_bounds"], s["shape_mult"])
    mean = torch.tensor(IMAGENET_MEAN, device=x.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=x.device) * 255.0
    x = F.pad((x - mean) / std, (0, 0, pl, pr, pt, pb))
    x = resize(x, (nh, nw))
    feats, cls_tokens = encoder(nx, p, s, x)
    K_given = None
    if intrinsics is not None:  # back to the network shape: undo the pads, then the resize
        K_given = intrinsics.float().clone()
        K_given[:, 0, 2] += pl
        K_given[:, 1, 2] += pt
        K_given = K_given * torch.tensor([[factor, 1.0, factor], [1.0, factor, factor], [1.0, 1.0, 1.0]], device=x.device)
    K, rays, radius, confidence = decoder(nx, p, s, feats, cls_tokens, (nh, nw), K_given)

    def post(t):
        t = resize(t, (ph, pw))
        return t[:, pt : ph - pb, pl : pw - pr]

    points = post(rays.reshape(B, nh, nw, 3) * radius)
    inv = 1.0 / factor
    K = K * torch.tensor([[inv, 1.0, inv], [1.0, inv, inv], [1.0, 1.0, 1.0]], device=x.device)
    K[:, 0, 2] -= pl
    K[:, 1, 2] -= pt
    return {"depth": points[..., 2:3], "confidence": post(confidence), "intrinsics": K}

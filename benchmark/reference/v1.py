"""Plain float32 reference of UniDepthV1 with a ConvNeXt encoder serving:
``infer(rgbs)`` from uint8 images to depth and intrinsics at the input
resolution.

Frozen at commit 9a9bd4f from the port's plain equations in
``unidepth_tpu_torch/models/unidepthv1/model.py`` (``infer``, ``_v1_shapes``,
``_v1_paddings``), ``models/unidepthv1/decoder.py``,
``models/backbones/convnext.py`` (``max_cls`` stacking), ``nn/layers.py``
(``AttentionBlock``, ``MLP``), ``nn/nystrom.py``, ``nn/upsample.py``
(``CvnxtBlock``, ``ConvUpsample``), ``ops/fourier.py``
(``position_embedding_sine``), ``ops/sht.py`` and ``geometry/rays.py``
(``generate_rays``). It imports torch, numpy and this folder only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .ops import IMAGENET_MEAN, IMAGENET_STD, Numerics, flat_interpolate, layer_norm, merge_heads, rays_from_K
from .ops import resize, split_heads
from .v2 import attention_block, mlp

CONVNEXT_PRESETS = {"convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536))}
NUM_LANDMARKS = 128


def model_sizes(config: dict) -> dict:
    pe = config["model"]["pixel_encoder"]
    depths, dims = CONVNEXT_PRESETS[pe["name"]]
    dec = config["model"]["pixel_decoder"]
    return {
        "depths": tuple(pe.get("depths", depths)),
        "dims": tuple(pe.get("dims", dims)),
        "hidden": dec["hidden_dim"],
        "decoder_depths": tuple(dec["depths"]),
        "heads": config["model"].get("num_heads", 8),
        "image_shape": tuple(config["data"]["image_shape"]),
    }


def fit_shape(image_hw, net_hw):
    """The aspect-preserving size inside the network shape, and its scale."""
    h, w = image_hw
    ratio = net_hw[0] / h if net_hw[1] / net_hw[0] > w / h else net_hw[1] / w
    return (math.ceil(h * ratio - 0.5), math.ceil(w * ratio - 0.5)), ratio


def network_shape(config: dict, image_hw) -> tuple[int, int]:
    return model_sizes(config)["image_shape"]


def convnext(nx: Numerics, p, s, image):
    """Per stage the max over its blocks (B, h, w, C), and the spatial-mean
    tokens (B, 1, C) of the last len(depths) blocks."""
    pre = "pixel_encoder."
    x = nx.conv2d(image.permute(0, 3, 1, 2), p[pre + "stem.0.weight"], p[pre + "stem.0.bias"], stride=4)
    x = layer_norm(x.permute(0, 2, 3, 1), p[pre + "stem.1.weight"], p[pre + "stem.1.bias"], 1e-6)
    feats, tokens = [], []
    remaining = sum(s["depths"])
    for si, depth in enumerate(s["depths"]):
        sp = f"{pre}stages.{si}."
        if si:
            y = layer_norm(x, p[sp + "downsample.0.weight"], p[sp + "downsample.0.bias"], 1e-6)
            x = nx.conv2d(y.permute(0, 3, 1, 2), p[sp + "downsample.1.weight"], p[sp + "downsample.1.bias"],
                          stride=2).permute(0, 2, 3, 1)
        stage_max = None
        for j in range(depth):
            bp = f"{sp}blocks.{j}."
            y = nx.conv2d(x.permute(0, 3, 1, 2), p[bp + "conv_dw.weight"], p[bp + "conv_dw.bias"], padding=3,
                          groups=x.shape[-1]).permute(0, 2, 3, 1)
            y = nx.ln_linear_gelu(y, p[bp + "norm.weight"], p[bp + "norm.bias"], 1e-6, p[bp + "mlp.fc1.weight"],
                                  p[bp + "mlp.fc1.bias"])
            x = x + nx.linear(y, p[bp + "mlp.fc2.weight"], p[bp + "mlp.fc2.bias"]) * p[bp + "gamma"]
            stage_max = x if stage_max is None else torch.maximum(stage_max, x)
            remaining -= 1
            if remaining < len(s["depths"]):
                tokens.append(x.mean(dim=(1, 2))[:, None])
        feats.append(stage_max)
    return feats, tokens


def position_embedding_sine(h, w, num_pos_feats, device):
    """DETR sine embedding of an (H, W) grid, positions normalised to
    (0, 2 pi], evaluated in float64 and rounded once."""
    y = np.arange(1, h + 1, dtype=np.float64)
    x = np.arange(1, w + 1, dtype=np.float64)
    y = y / (y[-1] + 1e-6) * 2.0 * math.pi
    x = x / (x[-1] + 1e-6) * 2.0 * math.pi
    dim_t = 10000.0 ** (2 * np.floor(np.arange(num_pos_feats) / 2) / num_pos_feats)

    def interleave(q):
        return np.stack([np.sin(q[:, 0::2]), np.cos(q[:, 1::2])], axis=2).reshape(q.shape[0], -1)

    pos_y, pos_x = interleave(y[:, None] / dim_t), interleave(x[:, None] / dim_t)
    out = np.concatenate([np.broadcast_to(pos_y[:, None], (h, w, num_pos_feats)),
                          np.broadcast_to(pos_x[None], (h, w, num_pos_feats))], axis=-1)
    return torch.as_tensor(out, dtype=torch.float32, device=device)


def rsh_cart_8(xyz):
    """Degree-8 real spherical harmonics (orthonormal, Condon-Shortley
    phase, index l (l + 1) + m) of unit vectors (..., 3) -> (..., 81)."""
    degree = 8
    x, y, z = xyz.unbind(-1)
    one = torch.ones_like(x)
    c, s = [one], [torch.zeros_like(x)]
    for m in range(1, degree + 1):
        c.append(x * c[m - 1] - y * s[m - 1])
        s.append(x * s[m - 1] + y * c[m - 1])
    pt = {(0, 0): one}
    for m in range(1, degree + 1):
        pt[(m, m)] = ((-1.0) ** m * math.prod(range(1, 2 * m, 2))) * one
    for m in range(degree):
        pt[(m + 1, m)] = (2 * m + 1) * z * pt[(m, m)]
    for m in range(degree + 1):
        for l in range(m + 2, degree + 1):
            pt[(l, m)] = ((2 * l - 1) * z * pt[(l - 1, m)] - (l - 1 + m) * pt[(l - 2, m)]) / (l - m)
    out = []
    for l in range(degree + 1):
        row = {}
        for m in range(l + 1):
            k = math.sqrt((2 * l + 1) / (4.0 * math.pi) * math.factorial(l - m) / math.factorial(l + m))
            if m == 0:
                row[0] = k * pt[(l, 0)]
            else:
                row[m] = math.sqrt(2.0) * k * pt[(l, m)] * c[m]
                row[-m] = math.sqrt(2.0) * k * pt[(l, m)] * s[m]
        out.extend(row[m] for m in range(-l, l + 1))
    return torch.stack(out, dim=-1)


def nystrom_attention(nx: Numerics, q, k, v):
    """Landmark attention over (B, H, N, D): 128 segment-mean landmarks and
    a 6-step Newton-Schulz pseudo-inverse; exact attention for N <= 128."""
    n, d = q.shape[-2:]
    if n <= NUM_LANDMARKS:
        return nx.attention(q, k, v)
    scale = d**-0.5

    def pool(t):
        b, h, n, d = t.shape
        seg, r = divmod(n, NUM_LANDMARKS)
        if r == 0:
            return t.reshape(b, h, NUM_LANDMARKS, seg, d).mean(dim=3)
        split = (NUM_LANDMARKS - r) * seg
        head = t[:, :, :split].reshape(b, h, NUM_LANDMARKS - r, seg, d).mean(dim=3)
        tail = t[:, :, split:].reshape(b, h, r, seg + 1, d).mean(dim=3)
        return torch.cat([head, tail], dim=2)

    q_l, k_l = pool(q), pool(k)

    def soft(a, b):
        return torch.softmax(nx.matmul(a, b.transpose(-1, -2)) * scale, dim=-1)

    k1, k2, k3 = soft(q, k_l), soft(q_l, k_l), soft(q_l, k)
    z = k2.transpose(-1, -2) / k2.sum(dim=-2).amax(dim=-1)[..., None, None]
    eye = torch.eye(k2.shape[-1], device=k2.device)
    for _ in range(6):
        kz = nx.matmul(k2, z)
        z = 0.25 * nx.matmul(z, 13.0 * eye - nx.matmul(kz, 15.0 * eye - nx.matmul(kz, 7.0 * eye - kz)))
    return nx.matmul(k1, nx.matmul(z, nx.matmul(k3, v)))


def nystrom_block(nx: Numerics, p, pre, x, heads, pos):
    """``attention_block`` with landmark attention, ``pos`` on q only."""
    y = layer_norm(x, p[pre + "norm_attnx.weight"], p[pre + "norm_attnx.bias"], 1e-5)
    c = layer_norm(x, p[pre + "norm_attnctx.weight"], p[pre + "norm_attnctx.bias"], 1e-5)
    k, v = nx.linear(c, p[pre + "kv.weight"], p[pre + "kv.bias"]).chunk(2, dim=-1)
    q = split_heads(nx.linear(y, p[pre + "q.weight"], p[pre + "q.bias"]), heads) + split_heads(pos, heads)
    a = nystrom_attention(nx, q, split_heads(k, heads), split_heads(v, heads))
    x = x + nx.linear(merge_heads(a), p[pre + "out.weight"], p[pre + "out.bias"]) * p[pre + "ls1.gamma"]
    return x + mlp(nx, p, pre + "mlp.", x) * p[pre + "ls2.gamma"]


def cvnxt_block(nx: Numerics, p, pre, x):
    """7x7 depthwise conv, LN (eps 1e-5) -> pwconv1 -> GELU, pwconv2, scale,
    residual, on (B, H, W, C)."""
    y = nx.conv2d(x.permute(0, 3, 1, 2), p[pre + "dwconv.weight"], p[pre + "dwconv.bias"], padding=3,
                  groups=x.shape[-1]).permute(0, 2, 3, 1)
    y = nx.ln_linear_gelu(y, p[pre + "norm.weight"], p[pre + "norm.bias"], 1e-5, p[pre + "pwconv1.weight"],
                          p[pre + "pwconv1.bias"])
    return x + nx.linear(y, p[pre + "pwconv2.weight"], p[pre + "pwconv2.bias"]) * p[pre + "gamma"]


def conv_upsample(nx: Numerics, p, pre, x):
    """Two ConvNeXt blocks, a 1x1 conv to half the channels, a 2x
    align-corners bilinear upsample and a 3x3 conv: (B, h, w, C) -> (B, 4hw,
    C/2)."""
    for j in range(2):
        x = cvnxt_block(nx, p, f"{pre}convs.{j}.", x)
    y = nx.conv2d(x.permute(0, 3, 1, 2), p[pre + "up.0.weight"], p[pre + "up.0.bias"])
    y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
    y = nx.conv2d(y, p[pre + "up.2.weight"], p[pre + "up.2.bias"], padding=1)
    return y.flatten(2).transpose(1, 2)


def adapter(nx: Numerics, p, pre, x):
    y = layer_norm(x, p[pre + "0.weight"], p[pre + "0.bias"], 1e-5)
    return F.gelu(nx.linear(y, p[pre + "1.weight"], p[pre + "1.bias"]))


def camera_head(nx: Numerics, p, s, feats, cls_tokens, pos_embed, hw):
    pre = "pixel_decoder.camera_layer."
    y = layer_norm(cls_tokens, p[pre + "cls_project.0.weight"], p[pre + "cls_project.0.bias"], 1e-5)
    y = F.gelu(nx.linear(y, p[pre + "cls_project.1.weight"], p[pre + "cls_project.1.bias"]))
    cls_tokens = nx.linear(y, p[pre + "cls_project.3.weight"], p[pre + "cls_project.3.bias"])
    stack = torch.cat(feats, dim=1) + pos_embed
    context = torch.cat([mlp(nx, p, pre + "in_features.", stack), cls_tokens], dim=1)
    pos = p[pre + "latents_pos"].expand(cls_tokens.shape[0], -1, -1)
    x = attention_block(nx, p, pre + "aggregate.", cls_tokens, 1, context=context, pos=pos)
    for i in range(2):
        x = attention_block(nx, p, f"{pre}layers.{i}.", x, s["heads"], pos=pos)
    x = mlp(nx, p, pre + "out.", x)[..., 0]
    h, w = hw
    half = max(hw) / 2.0
    K = torch.zeros(x.shape[0], 3, 3, device=x.device)
    K[:, 0, 0], K[:, 1, 1] = torch.exp(x[:, 0]) * half, torch.exp(x[:, 1]) * half
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = torch.sigmoid(x[:, 2]) * w, torch.sigmoid(x[:, 3]) * h, 1.0
    return K


def decoder(nx: Numerics, p, s, feats, cls_tokens, hw, K_given=None):
    """The V1 decoder: K (B, 3, 3) and the three depth maps (B, 2^i h16,
    2^i w16, 1) from the 1/16 grid up. With ``K_given`` (B, 3, 3) at the
    network shape, its rays condition the depth head in place of the camera
    head's own (whose K is still returned)."""
    pre = "pixel_decoder."
    H, W = hw
    b = feats[0].shape[0]
    level_shapes = sorted({tuple(f.shape[1:3]) for f in feats}, reverse=True)
    gh, gw = level_shapes[-2] if len(level_shapes) > 1 else level_shapes[0]
    n = gh * gw
    tokens = [adapter(nx, p, f"{pre}input_adapter.input_adapters.{i}.",
                      flat_interpolate(f.reshape(b, -1, f.shape[-1]), tuple(f.shape[1:3]), (gh, gw)))
              for i, f in enumerate(feats)]
    cams = [adapter(nx, p, f"{pre}token_adapter.input_adapters.{i}.", t) for i, t in enumerate(cls_tokens[::-1])]
    le = nx.linear(F.gelu(nx.linear(p[pre + "level_embeds"], p[pre + "level_embed_layer.0.weight"],
                                    p[pre + "level_embed_layer.0.bias"])),
                   p[pre + "level_embed_layer.2.weight"], p[pre + "level_embed_layer.2.bias"])
    le = layer_norm(le, p[pre + "level_embed_layer.3.weight"], p[pre + "level_embed_layer.3.bias"], 1e-5)
    hidden = le.shape[-1]
    level_embed = le.repeat_interleave(n, dim=0)[None].expand(b, -1, -1)
    pos = position_embedding_sine(gh, gw, hidden // 2, le.device).reshape(1, n, hidden)
    pos_embed = pos.repeat(1, len(tokens), 1).expand(b, -1, -1)

    K = camera_head(nx, p, s, tokens, torch.cat(cams, dim=1), pos_embed + level_embed, hw)
    rays = rays_from_K(K if K_given is None else K_given, H, W, 1e-12)

    dp = pre + "depth_layer."
    embs = []
    for scale, key in ((1, "project_rays16."), (2, "project_rays8."), (4, "project_rays4.")):
        r = flat_interpolate(rays, hw, (scale * gh, scale * gw), antialias=True)
        r = r / torch.linalg.norm(r, dim=-1, keepdim=True).clamp_min(1e-12)
        embs.append(mlp(nx, p, dp + key, rsh_cart_8(r)))
    latents = nx.linear(torch.cat(tokens, dim=-1), p[dp + "features_channel_cat.weight"],
                        p[dp + "features_channel_cat.bias"])
    latents = mlp(nx, p, dp + "to_latents.", latents)
    latents = attention_block(nx, p, dp + "aggregate_16.", latents, 1, context=torch.cat(tokens, dim=1),
                              pos_context=pos_embed + level_embed)
    latents = attention_block(nx, p, dp + "prompt_camera.", latents, 1, context=embs[0])
    outs, shape = [], (gh, gw)
    heads = [max(1, s["heads"] >> li) for li in range(3)]
    for li, (name, scale) in enumerate((("layers_16", 8), ("layers_8", 4), ("layers_4", 2))):
        for j in range(s["decoder_depths"][li]):
            if li == 0:
                latents = attention_block(nx, p, f"{dp}{name}.{j}.", latents, heads[li], pos=embs[li])
            else:
                latents = nystrom_block(nx, p, f"{dp}{name}.{j}.", latents, heads[li], embs[li])
        latents = conv_upsample(nx, p, f"{dp}up{scale}.", (latents + embs[li]).reshape(b, *shape, -1))
        shape = (2 * shape[0], 2 * shape[1])
        grid = latents.reshape(b, *shape, -1).permute(0, 3, 1, 2)
        out = nx.conv2d(grid, p[f"{dp}out{scale}.weight"], p[f"{dp}out{scale}.bias"], padding=1)
        outs.append(torch.exp(out.permute(0, 2, 3, 1).clamp(-10.0, 10.0)))
    return K, outs


def infer(nx: Numerics, p: dict, config: dict, rgb: torch.Tensor, intrinsics=None) -> dict:
    """rgb: (B, H, W, 3) uint8 on the device. Returns float32 ``depth`` (B,
    H, W, 1) and ``intrinsics`` (B, 3, 3) at the input resolution.
    ``intrinsics`` (B, 3, 3) at the input resolution, when given, are the
    camera the depth head is conditioned on; the returned intrinsics are
    always the reference's own."""
    s = model_sizes(config)
    x = rgb.float() / 255.0
    B, H, W, _ = x.shape
    nh, nw = s["image_shape"]
    (sh, sw), ratio = fit_shape((H, W), (nh, nw))
    pl, pt = (nw - sw) // 2, (nh - sh) // 2
    pr, pb = nw - sw - pl, nh - sh - pt
    x = (x - torch.tensor(IMAGENET_MEAN, device=x.device)) / torch.tensor(IMAGENET_STD, device=x.device)
    x = F.pad(resize(x, (sh, sw), antialias=True), (0, 0, pl, pr, pt, pb))
    inv = 1.0 / ratio
    scale = torch.tensor([[inv, 1.0, inv], [1.0, inv, inv], [1.0, 1.0, 1.0]], device=x.device)
    shift = torch.tensor([[0.0, 0.0, pl * inv], [0.0, 0.0, pt * inv], [0.0, 0.0, 0.0]], device=x.device)
    K_given = None if intrinsics is None else (intrinsics.float() + shift) / scale  # back to the network shape
    feats, tokens = convnext(nx, p, s, x)
    K, preds = decoder(nx, p, s, feats, tokens, (nh, nw), K_given)
    pred = sum(resize(d, (nh, nw), antialias=True) for d in preds) / len(preds)
    pred = resize(pred[:, pt : nh - pb, pl : nw - pr], (H, W), antialias=True)
    return {"depth": pred, "intrinsics": K * scale - shift}

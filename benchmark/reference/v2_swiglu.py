"""Plain float32 reference of UniDepthV2 serving with a DINOv2 encoder whose
blocks take SwiGLU FFNs (DINOv2 ViT-g/14): ``infer(rgb)`` with its default
outputs, from uint8 images to depth, confidence and intrinsics at the input
resolution.

The encoder follows DINOv2's published ViT-g/14 (arXiv:2304.07193,
``facebook/dinov2-giant``): pre-LN blocks with LayerScale, LayerNorm eps
1e-6, and the fused SwiGLU FFN ``w3(silu(a) * g)`` with ``(a, g)`` the halves
of ``w12(LN2(x))``. The rest (pre- and postprocessing, the V2 decoder and
camera head) is ``reference/v2.py``'s, imported as it is. It imports torch
and this folder only; the weights come as a dict of float32 tensors under
the reference checkpoint's names.

Departures from the published description, each as the port runs it:

* ``output_idx`` (10, 20, 30, 40) is assumed: no UniDepth checkpoint with
  this encoder is published, so the outputs sit at the quarter points, as
  ViT-L's (6, 12, 18, 24) do;
* the position embedding is resized to the patch grid as
  ``reference/v2.py`` resizes ViT-L's (bicubic from the 37 x 37 grid, no
  offset), the port's V2 rule;
* SwiGLU's FFN work is counted twice in ``Numerics.tally``: its two linears
  in ``flops`` like every product, and LN2 -> w12 -> ``silu(a) * g``, the
  call the port fuses, in the ``ln_dense_*`` fields (2 M C F FLOPs; x,
  ``w12``, its bias and the LN parameters read once and the (M, F / 2)
  result written once, in bf16). This encoder has no GELU MLP, so those
  fields hold the gated call alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import v2
from .ops import BF16_BYTES, IMAGENET_MEAN, IMAGENET_STD, Numerics, layer_norm, merge_heads, resize

#: name -> (embed_dim, depth, heads, output_idx)
VIT_PRESETS = {"vitg14": (1536, 40, 24, (10, 20, 30, 40))}
PATCH = v2.PATCH


def model_sizes(config: dict) -> dict:
    """``reference/v2.py``'s sizes for a SwiGLU encoder, read from a
    reference-schema config: the preset's, each overridable by its key."""
    pe = config["model"]["pixel_encoder"]
    dim, depth, heads, output_idx = VIT_PRESETS[pe["name"].replace("dinov2_", "")]
    dec = config["model"]["pixel_decoder"]
    sc = config["data"]["augmentations"]["shape_constraints"]
    return {
        "embed_dim": pe.get("embed_dim", dim),
        "depth": pe.get("depth", depth),
        "heads": pe.get("num_heads", heads),
        "pos_embed_size": pe.get("pos_embed_size", 37),
        "output_idx": tuple(pe.get("output_idx", output_idx)),
        "use_norm": pe.get("use_norm", False),
        "hidden": dec["hidden_dim"],
        "decoder_heads": config["model"].get("num_heads", 8),
        "ratio_bounds": tuple(sc["ratio_bounds"]),
        "pixels_bounds": (sc["pixels_min"], sc["pixels_max"]),
        "shape_mult": sc.get("shape_mult", 14),
    }


def network_shape(config: dict, image_hw) -> tuple[int, int]:
    s = model_sizes(config)
    _, padded = v2.paddings(tuple(image_hw), s["ratio_bounds"])
    return v2.resize_factor(padded, s["pixels_bounds"], s["shape_mult"])[1]


def swiglu(nx: Numerics, x, norm_w, norm_b, eps, w12, b12, w3, b3):
    """``w3(silu(a) * g)``, ``(a, g)`` the halves of ``w12(LayerNorm(x))``."""
    if nx.tally is not None:
        m, c, f = x.numel() // x.shape[-1], w12.shape[1], w12.shape[0]
        nx.tally.ln_dense_flops += 2.0 * m * c * f
        nx.tally.ln_dense_bytes += BF16_BYTES * (m * c + f * c + f + 2 * c + m * f // 2)
        nx.tally.ln_dense_calls += 1
    a, g = nx.linear(layer_norm(x, norm_w, norm_b, eps), w12, b12).chunk(2, dim=-1)
    return nx.linear(F.silu(a) * g, w3, b3)


def encoder(nx: Numerics, p, s, image):
    """DINOv2 with SwiGLU FFNs on (B, H, W, 3) normalised images: per output
    index, the normed patch features (B, h, w, C) and cls token (B, 1, C)."""
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
        m = swiglu(nx, x, p[bp + "norm2.weight"], p[bp + "norm2.bias"], 1e-6, p[bp + "mlp.w12.weight"],
                   p[bp + "mlp.w12.bias"], p[bp + "mlp.w3.weight"], p[bp + "mlp.w3.bias"])
        x = x + m * p[bp + "ls2.gamma"]
        if i + 1 in s["output_idx"]:
            out = layer_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"], 1e-6) if s["use_norm"] else x
            cls_tokens.append(out[:, :1])
            feats.append(out[:, 1:].reshape(b, gh, gw, c))
    return feats, cls_tokens


def infer(nx: Numerics, p: dict, config: dict, rgb: torch.Tensor, intrinsics=None) -> dict:
    """``reference/v2.py`` ``infer`` with this file's encoder: rgb (B, H, W,
    3) uint8 on the device; float32 ``depth`` and ``confidence`` (B, H, W,
    1) and ``intrinsics`` (B, 3, 3) at the input resolution. ``intrinsics``
    (B, 3, 3) at the input resolution, when given, are the camera the depth
    head is conditioned on; the returned intrinsics are the reference's
    own."""
    s = model_sizes(config)
    x = rgb.float()
    B, H, W, _ = x.shape
    (pl, pr, pt, pb), (ph, pw) = v2.paddings((H, W), s["ratio_bounds"])
    factor, (nh, nw) = v2.resize_factor((ph, pw), s["pixels_bounds"], s["shape_mult"])
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
    K, rays, radius, confidence = v2.decoder(nx, p, s, feats, cls_tokens, (nh, nw), K_given)

    def post(t):
        t = resize(t, (ph, pw))
        return t[:, pt : ph - pb, pl : pw - pr]

    points = post(rays.reshape(B, nh, nw, 3) * radius)
    inv = 1.0 / factor
    K = K * torch.tensor([[inv, 1.0, inv], [1.0, inv, inv], [1.0, 1.0, 1.0]], device=x.device)
    K[:, 0, 2] -= pl
    K[:, 1, 2] -= pt
    return {"depth": points[..., 2:3], "confidence": post(confidence), "intrinsics": K}

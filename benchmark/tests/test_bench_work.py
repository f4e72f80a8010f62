"""The reference's work counts against hand counts, and the readers that
turn them into roofline and peak shares."""

from __future__ import annotations

import json

import pytest
import torch
from conftest import ROOT

from benchmark.reference import v1, v2
from benchmark.reference.ops import Numerics, Tally


def vit_s_config():
    config = json.loads((ROOT / "benchmark" / "configs" / "v2-vitl14.json").read_text())["config"]
    config["model"]["pixel_encoder"].update(name="dinov2_vits14", output_idx=[3, 6, 9, 12])
    return config


def test_vit_s_encoder_counts():
    """DINOv2 ViT-S/14 (C 384, 12 blocks, 6 heads) at 518x518: a block is
    qkv, proj, fc1 and fc2 (24 N C^2) and the attention (4 N^2 C)."""
    config = vit_s_config()
    s = v2.model_sizes(config)
    c, depth, heads, n_patch = 384, 12, 6, 37 * 37
    n = n_patch + 1
    p = {"pixel_encoder.patch_embed.proj.weight": torch.empty(c, 3, 14, 14, device="meta"),
         "pixel_encoder.patch_embed.proj.bias": torch.empty(c, device="meta"),
         "pixel_encoder.pos_embed": torch.empty(1, n_patch + 1, c, device="meta"),
         "pixel_encoder.cls_token": torch.empty(1, 1, c, device="meta"),
         "pixel_encoder.norm.weight": torch.empty(c, device="meta"),
         "pixel_encoder.norm.bias": torch.empty(c, device="meta")}
    shapes = {"norm1.weight": (c,), "norm1.bias": (c,), "attn.qkv.weight": (3 * c, c), "attn.qkv.bias": (3 * c,),
              "attn.proj.weight": (c, c), "attn.proj.bias": (c,), "ls1.gamma": (c,), "norm2.weight": (c,),
              "norm2.bias": (c,), "mlp.fc1.weight": (4 * c, c), "mlp.fc1.bias": (4 * c,),
              "mlp.fc2.weight": (c, 4 * c), "mlp.fc2.bias": (c,), "ls2.gamma": (c,)}
    for i in range(depth):
        p.update({f"pixel_encoder.blocks.{i}.{k}": torch.empty(v, device="meta") for k, v in shapes.items()})
    tally = Tally()
    feats, tokens = v2.encoder(Numerics(tally=tally), p, s, torch.empty(2, 518, 518, 3, device="meta"))
    assert len(feats) == 4 and feats[0].shape == (2, 37, 37, c)
    b = 2
    patch = 2 * b * n_patch * c * 3 * 14 * 14
    block = b * (24 * n * c * c + 4 * n * n * c)
    assert tally.flops == patch + depth * block
    assert tally.attention_flops == depth * b * 4 * n * n * c
    assert tally.attention_calls == depth
    assert tally.attention_bytes == depth * b * 2 * 4 * n * c  # q, k, v read, o written, bf16
    assert tally.ln_dense_flops == depth * b * 2 * n * c * 4 * c
    assert tally.ln_dense_calls == depth


def test_conv_and_transpose_counts():
    nx = Numerics(tally=Tally())
    x = torch.empty(2, 16, 10, 12, device="meta")
    nx.conv2d(x, torch.empty(8, 16, 3, 3, device="meta"), padding=1)
    assert nx.tally.flops == 2 * 2 * 8 * 10 * 12 * 16 * 9
    nx.conv2d(x, torch.empty(16, 1, 7, 7, device="meta"), padding=3, groups=16)  # depthwise
    assert nx.tally.flops == 2 * 2 * 8 * 10 * 12 * 16 * 9 + 2 * 2 * 16 * 10 * 12 * 49
    before = nx.tally.flops
    out = nx.conv_transpose_patch(x, torch.empty(16, 4, 2, 2, device="meta"), None)
    assert out.shape == (2, 4, 20, 24)
    assert nx.tally.flops - before == 2 * 2 * 10 * 12 * 16 * 4 * 4


def test_v1_convnext_block_counts():
    """A ConvNeXt block: the 7x7 depthwise conv, then fc1 and fc2 at 4C."""
    config = json.loads((ROOT / "benchmark" / "configs" / "v1-cnvnxtl.json").read_text())["config"]
    s = {**v1.model_sizes(config), "depths": (1,), "dims": (64,)}
    c, h, w = 64, 8, 12
    p = {"pixel_encoder.stem.0.weight": torch.empty(c, 3, 4, 4, device="meta"),
         "pixel_encoder.stem.0.bias": torch.empty(c, device="meta")}
    for k, shape in {"stem.1.weight": (c,), "stem.1.bias": (c,), "stages.0.blocks.0.conv_dw.weight": (c, 1, 7, 7),
                     "stages.0.blocks.0.conv_dw.bias": (c,), "stages.0.blocks.0.norm.weight": (c,),
                     "stages.0.blocks.0.norm.bias": (c,), "stages.0.blocks.0.mlp.fc1.weight": (4 * c, c),
                     "stages.0.blocks.0.mlp.fc1.bias": (4 * c,), "stages.0.blocks.0.mlp.fc2.weight": (c, 4 * c),
                     "stages.0.blocks.0.mlp.fc2.bias": (c,), "stages.0.blocks.0.gamma": (c,)}.items():
        p[f"pixel_encoder.{k}"] = torch.empty(shape, device="meta")
    tally = Tally()
    feats, tokens = v1.convnext(Numerics(tally=tally), p, s, torch.empty(1, 4 * h, 4 * w, 3, device="meta"))
    m = h * w
    assert feats[0].shape == (1, h, w, c) and len(tokens) == 1
    assert tally.flops == 2 * m * c * 48 + 2 * m * c * 49 + 2 * (2 * m * c * 4 * c)
    assert tally.ln_dense_flops == 2 * m * c * 4 * c
    assert tally.ln_dense_bytes == 2 * (m * c + 4 * c * c + 4 * c + 2 * c + m * 4 * c)


def _reader(name):
    from benchmark.harness import registry

    return registry.reader(ROOT, name)


def test_roofline_and_mfu_readers():
    work = {"518x518": {"flops": 1e12, "attention_flops": 2e11, "attention_bytes": 1e6, "ln_dense_flops": 3e11,
                        "ln_dense_bytes": 1e8}}
    peaks = {"bf16_flops": 1e15, "hbm_bytes_per_s": 2e12}
    record = {
        "window_s": 10.0, "work": work, "peaks": peaks,
        "requests": [{"camera": [518, 518], "images": 8, "latency_ms": 50.0}] * 100,
        "trace": {"busy_s": 0.8, "span_s": 1.0, "idle": {},
                  "device_ops": {"void attn_fwd_wgmma<0, 1, 3, 64>(CUtensorMap)": 0.004, "ud_ln_row_stats": 0.001,
                                 "ln_dense_wgmma(...)": 0.011, "gemm": 0.5},
                  "requests": [{"camera": [518, 518], "images": 8}] * 2},
    }
    # attention: 2 x 8 x 2e11 FLOPs at 1e15 = 3.2 ms (bytes 8 us) over 4 ms
    assert _reader("attention_roofline.serve")(record) == pytest.approx(80.0)
    # K2: 4.8e12 FLOPs = 4.8 ms, 1.6e9 bytes = 0.8 ms: bound by FLOPs, over 12 ms
    assert _reader("ln_dense_roofline.serve")(record) == pytest.approx(40.0)
    assert _reader("mfu.serve")(record) == pytest.approx(100.0 * 800 * 1e12 / 10.0 / 1e15)
    assert _reader("idle_share.serve")(record) == pytest.approx(20.0)
    assert _reader("attention_roofline.serve")({**record, "trace": {**record["trace"], "device_ops": {}}}) is None
    assert _reader("mfu.serve")({**record, "peaks": None}) is None

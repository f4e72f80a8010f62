"""UniDepthV1's int8 serving in the port against the JAX package on shared
fp32 weights, CPU.

Model: the tiny V1 of tests/test_torch_v1.py (DINOv2 C = 64, 4 blocks, 2
heads, one block a stage, ``max_cls`` stacking; decoder hidden 32) with the
JAX init plus seeded noise, two seeded 56 x 70 images. V1 exponentiates its
depth logits, so int8 is refused until ``calibrate_int8_stages`` has stored
a stage mask (the JAX ``INT8_REQUIRES_CALIBRATION``). The calibration's
mask and the order of its per-stage errors equal JAX's, the solo errors at
rtol 2e-2 (one int8 activation code may flip between the packages: their
LayerNorms differ by an ulp). The int8 copy of the ``max_cls`` encoder
under that mask: weight codes and scales equal JAX ``quantize_dense_tree``
bit for bit from a bf16 model's fp32 masters, and its features and tail
cls tokens hold JAX's int8 encoder on the same input at median relative
error <= 1e-3. A ConvNeXt encoder refuses int8 with JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.models.backbones.convnext import ConvNeXt as JConvNeXt
from unidepth_tpu.models.backbones.convnext import ConvNeXtConfig as JConvNeXtConfig
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.models.unidepthv1.model import UniDepthV1 as JUniDepthV1
from unidepth_tpu.ops.quant import quantize_dense_tree
from unidepth_tpu_torch.io.convert import from_jax_params
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_qkv

CFG = {
    "model": {
        "name": "UniDepthV1", "num_heads": 4, "expansion": 4,
        "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2,
            "pos_embed_size": 8, "output_idx": [1, 2, 3, 4],
        },
    },
    "data": {"image_shape": [56, 70]},
}
VIT = dict(embed_dim=64, depth=4, num_heads=2, pos_embed_size=8, output_idx=(1, 2, 3, 4), use_norm=False,
           interpolate_offset=0.1)
CNX_CFG = {
    "model": {
        "name": "UniDepthV1", "num_heads": 4, "expansion": 4,
        "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
        "pixel_encoder": {"name": "convnext_large", "depths": [1, 1, 2, 1], "dims": [32, 64, 128, 256]},
    },
    "data": {"image_shape": [64, 96]},
}


def _jit_init(jm, seed):
    k1, k2 = jax.random.split(jax.random.key(seed))
    img = jnp.zeros((1, *jm.image_shape, 3), jnp.float32)
    enc = jax.jit(jm.encoder.init)(k1, img)
    feats, cls_tokens = jax.eval_shape(jm.encoder.apply, enc, img)
    zeros = [[jnp.zeros(t.shape, jnp.float32) for t in ts] for ts in (feats, cls_tokens)]
    dec = jax.jit(jm.decoder.init, static_argnums=3)(k2, *zeros, jm.image_shape)
    return {"encoder": enc["params"], "decoder": dec["params"]}


@pytest.fixture(scope="module")
def calibrated():
    """(JAX model, port model, images, the two calibration reports), both
    models left in int8 under their calibrated masks."""
    jm = JUniDepthV1(JViTConfig(**VIT), hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=4, image_shape=(56, 70),
                     dtype=jnp.float32)
    rng = np.random.default_rng(7)
    jm.params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), _jit_init(jm, 0))
    tm = UniDepthV1.from_config(CFG, device="cpu")
    tm.load_state_dict(from_jax_params(jm.params, CFG))
    tm.eval()
    rgb = np.random.default_rng(1).integers(0, 256, (2, 56, 70, 3), dtype=np.uint8)
    for m in (jm, tm):
        with pytest.raises(ValueError, match="calibrate_int8_stages"):
            m.set_serving_precision("int8")
    reports = jm.calibrate_int8_stages(rgb), tm.calibrate_int8_stages(rgb)
    for m in (jm, tm):
        m.set_serving_precision("int8")
    return jm, tm, rgb, reports


def test_calibrate_int8_stages_matches_jax(calibrated):
    _, tm, _, (rep_j, rep_t) = calibrated
    assert rep_t["selected"] == rep_j["selected"] == tm._int8_stages
    assert 0 < sum(rep_t["selected"]) < 4  # the default budget (0.05) leaves a stage out
    assert [i for i, _ in rep_t["per_stage"]] == [i for i, _ in rep_j["per_stage"]]
    np.testing.assert_allclose([e for _, e in rep_t["per_stage"]], [e for _, e in rep_j["per_stage"]], rtol=2e-2)
    assert rep_t["rel_err"] <= rep_t["max_rel_err"] == 0.05
    np.testing.assert_allclose(rep_t["rel_err"], rep_j["rel_err"], rtol=2e-2)


def test_int8_infer_runs_the_calibrated_stages(calibrated):
    """``infer`` runs the int8 copy: its selected stages' blocks on int8
    GEMMs and the packed attention (plain on the CPU), the others fused;
    depth stays within the calibration's budget of the default path."""
    _, tm, rgb, (_, rep) = calibrated
    enc = tm._serving_encoder()
    assert enc is not tm.pixel_encoder and enc.stacking == "max_cls"
    assert [b.quant for b in enc.blocks] == list(rep["selected"])
    assert not any(b.quant for b in tm.pixel_encoder.blocks)
    before = flash_attention_packed.launches, flash_attention_qkv.launches
    out = tm.infer(rgb)
    assert (flash_attention_packed.launches, flash_attention_qkv.launches) == before  # the CPU runs the plain versions
    try:
        tm.set_serving_precision("default")
        ref = tm.infer(rgb)
    finally:
        tm.set_serving_precision("int8")
    rel = ((out["depth"] - ref["depth"]).abs() / (ref["depth"].abs() + 1e-6)).mean().item()
    np.testing.assert_allclose(rel, rep["rel_err"], rtol=1e-5)


def test_int8_max_cls_encoder_matches_jax(calibrated):
    """Under the calibrated mask the port's int8 ``max_cls`` encoder (running
    max over each stage's blocks, the tail cls tokens) against JAX's int8
    encoder on the same normalised input."""
    jm, tm, rgb, _ = calibrated
    x = np.array(jm._audit_preprocess(rgb))
    enc_j = jm._serving_encoder()
    feats_j, cls_j = jax.jit(enc_j.apply)({"params": jm._serving_params()["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        feats_t, cls_t = tm._serving_encoder()(torch.from_numpy(x))
    assert len(feats_t) == len(feats_j) == len(cls_t) == len(cls_j) == 4
    for t, j in zip(feats_t + cls_t, list(feats_j) + list(cls_j)):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        rel = np.abs(t.numpy() - j) / (np.abs(j) + 1e-6)
        assert np.median(rel) <= 1e-3, np.median(rel)


def test_int8_codes_from_fp32_masters_match_jax(calibrated):
    """A bf16 V1 loaded from fp32 weights quantizes its selected stages from
    the fp32 masters: codes and scales equal JAX ``quantize_dense_tree``
    bit for bit; the other stages keep their linears."""
    jm, _, _, (_, rep) = calibrated
    tb = UniDepthV1.from_config(CFG, device="cpu", dtype=torch.bfloat16)
    tb.load_state_dict(from_jax_params(jm.params, CFG))
    tb._int8_stages = rep["selected"]
    tb.set_serving_precision("int8")
    qp = quantize_dense_tree(jm.params["encoder"])
    enc = tb._serving_encoder()
    for i, (blk, on) in enumerate(zip(enc.blocks, rep["selected"])):
        assert blk.quant == on
        if not on:
            assert blk is tb.pixel_encoder.blocks[i]
            continue
        for key, layer in (("qkv", blk.attn.qkv), ("proj", blk.attn.proj), ("fc1", blk.mlp.fc1),
                           ("fc2", blk.mlp.fc2)):
            ref = qp[f"stage_{i}"][key]
            assert (layer.weight.dtype, layer.scale.dtype) == (torch.int8, torch.float32)
            np.testing.assert_array_equal(layer.weight.numpy().T, np.asarray(ref["kernel"][0]))
            np.testing.assert_array_equal(layer.scale.numpy(), np.asarray(ref["scale"][0]))
            np.testing.assert_array_equal(layer.bias.numpy(), np.asarray(ref["bias"][0]))


def test_init_params_keeps_fp32_masters_of_the_vit_only():
    """``init_params`` of a bf16 V1 keeps the fp32 draws of its ViT linears
    for int8 (4 a block); a ConvNeXt V1 keeps none."""
    vit = UniDepthV1.from_config(CFG, device="cpu", dtype=torch.bfloat16).init_params(seed=0)
    assert len(vit._fp32_masters) == 4 * 4
    w, _ = vit._fp32_masters["blocks.2.mlp.fc1"]
    assert w.dtype == torch.float32 and torch.equal(w.to(torch.bfloat16), vit.pixel_encoder.blocks[2].mlp.fc1.weight)
    cnx = UniDepthV1.from_config(CNX_CFG, device="cpu", dtype=torch.bfloat16).init_params(seed=0)
    assert cnx._fp32_masters is None


def test_convnext_refuses_int8_as_jax_does():
    jm = JUniDepthV1(None, hidden_dim=32, image_shape=(64, 96), dtype=jnp.float32,
                     encoder_module=JConvNeXt(cfg=JConvNeXtConfig(depths=(1, 1, 2, 1), dims=(32, 64, 128, 256)),
                                              stacking="max_cls", dtype=jnp.float32))
    tm = UniDepthV1.from_config(CNX_CFG, device="cpu")
    rgb = np.zeros((1, 64, 96, 3), np.uint8)
    for call in (lambda m: m.set_serving_precision("int8"), lambda m: m.calibrate_int8_stages(rgb)):
        with pytest.raises(ValueError) as want:
            call(jm)
        with pytest.raises(ValueError) as got:
            call(tm)
        assert str(got.value) == str(want.value)
        assert "requires a ViT encoder" in str(got.value)
    assert tm.serving_precision == "default"

"""The port's int8 serving (``set_serving_precision('int8')``) against the JAX
package's on shared fp32 weights, CPU, fp32 compute.

Model: the tiny V2 of tests/test_torch_v2_infer.py (encoder named ViT-S,
C=128, 4 blocks, 2 heads, one block per stage), a shrunk pixel budget and
weights from the JAX init plus seeded numpy noise. Depth is held to a
median relative error <= 1e-3. Measured on these seeds: blanket int8
median 3.2e-6, max 2.3e-2; under the stage mask median 2.5e-6, max 1.2e-2.

The max is an int8 code flip, not drift: int8 activation codes turn a
1-ulp difference in a LayerNorm output (flax computes the variance as
E[x^2] - E[x]^2, PyTorch in two passes) into one whole quantization step of
one element, and that step spreads over the pixels of the token it hit.
Codes and scales from the same inputs are bit-identical
(tests/test_torch_quant.py). At the real ViT-S widths (12 blocks, C=384)
the flips compound through the random blocks to a median of 2.8e-3
(measured, JAX init weights, one 56x70 image), which is why the model here
is tiny.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.models.unidepthv2.model import UniDepthV2 as JUniDepthV2
from unidepth_tpu.ops.quant import quantize_dense_tree
from unidepth_tpu_torch.io.convert import from_jax_params
from unidepth_tpu_torch.models.backbones.dinov2 import DinoViT, ViTConfig
from unidepth_tpu_torch.models.serving import ServingPrecisionMixin
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.ops.flash_attention import flash_attention_packed, flash_attention_qkv
from unidepth_tpu_torch.ops.quant import quantize_kernel

CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2, "expansion": 4, "layer_scale": 1.0,
        "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 1, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 128, "depth": 4, "num_heads": 2,
            "pos_embed_size": 8, "output_idx": [1, 2, 3, 4], "use_norm": True,
        },
    },
    "data": {"augmentations": {"shape_constraints": {
        "ratio_bounds": [0.5, 2.5], "pixels_min": 4000, "pixels_max": 10000}}},
}
MASK = (True, False, True, False)

pytestmark = pytest.mark.filterwarnings("ignore:resolution_level not set")


@pytest.fixture(scope="module")
def models():
    jm = JUniDepthV2.from_config(CFG, dtype=jnp.float32)
    jm.params = jax.jit(lambda: jm.init_params(seed=0, image_shape=(56, 70)))()  # the eager init's bits, ~3x sooner
    rng = np.random.default_rng(0)
    jm.params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), jm.params
    )
    tm = UniDepthV2.from_config(CFG, device="cpu")
    tm.load_state_dict(from_jax_params(jm.params, CFG))
    return jm, tm.eval()


@pytest.fixture
def rgb():
    return np.random.default_rng(1).integers(0, 256, (2, 56, 70, 3), dtype=np.uint8)


def _serve(model, mode, mask=None):
    model._int8_stages = mask
    model.set_serving_precision(mode)
    model._reset_serving_caches()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / np.abs(b)


@pytest.mark.parametrize("mask", [None, MASK], ids=["blanket", "stage-mask"])
def test_int8_infer_matches_jax(models, rgb, mask):
    jm, tm = models
    try:
        for m in models:
            _serve(m, "int8", mask)
        ref = jm.infer(rgb)
        before = flash_attention_packed.launches, flash_attention_qkv.launches
        out = tm.infer(rgb)
        assert (flash_attention_packed.launches, flash_attention_qkv.launches) == before  # CPU: plain
    finally:
        for m in models:
            _serve(m, "default")
    enc = tm.pixel_encoder.quantize(True if mask is None else mask)
    assert [b.quant for b in enc.blocks] == ([True] * 4 if mask is None else list(mask))
    rel = _rel(out["depth"].numpy(), ref["depth"])
    assert np.median(rel) <= 1e-3, (np.median(rel), rel.max())


def test_int8_encoder_is_quantized_from_fp32_masters(models):
    """A model cast to bf16 after its weights were loaded still quantizes
    from the fp32 values: codes and scales equal JAX ``quantize_dense_tree``
    bit for bit, and stay int8 / fp32 under another ``.to(bfloat16)``."""
    jm, _ = models
    tm = UniDepthV2.from_config(CFG, device="cpu")
    tm.load_state_dict(from_jax_params(jm.params, CFG))
    tm.to(torch.bfloat16).set_serving_precision("int8")
    qp = quantize_dense_tree(jm.params["encoder"])
    enc = tm._serving_encoder().to(torch.bfloat16)
    assert tm._serving_encoder() is enc
    stale = 0
    for i, blk in enumerate(enc.blocks):
        ref = qp[f"stage_{i}"]["fc1"]
        layer = blk.mlp.fc1
        assert (layer.weight.dtype, layer.scale.dtype, layer.bias.dtype) == (torch.int8, torch.float32, torch.float32)
        np.testing.assert_array_equal(layer.weight.numpy().T, np.asarray(ref["kernel"][0]))
        np.testing.assert_array_equal(layer.scale.numpy(), np.asarray(ref["scale"][0]))
        np.testing.assert_array_equal(layer.bias.numpy(), np.asarray(ref["bias"][0]))
        q_bf16, _ = quantize_kernel(tm.pixel_encoder.blocks[i].mlp.fc1.weight)
        stale += int((q_bf16 != layer.weight).sum())
    assert stale > 0  # quantizing the bf16 copy would have given other codes


def test_fp32_masters_are_kept_only_below_fp32(models):
    """An fp32 model keeps no copy of its encoder linears; a cast below fp32
    takes one, a cast back drops it, and a bf16 model loading fp32 weights
    keeps them bit for bit."""
    jm, _ = models
    sd = from_jax_params(jm.params, CFG)
    tm = UniDepthV2.from_config(CFG, device="cpu")
    tm.load_state_dict(sd)
    assert tm._fp32_masters is None
    tm.init_params(seed=1)
    assert tm._fp32_masters is None
    fc1 = tm.pixel_encoder.blocks[0].mlp.fc1.weight.clone()
    tm.to(torch.bfloat16)
    assert len(tm._fp32_masters) == 4 * 4  # qkv, proj, fc1, fc2 in 4 blocks
    assert torch.equal(tm._fp32_masters["blocks.0.mlp.fc1"][0], fc1)
    tm.float()
    assert tm._fp32_masters is None
    tb = UniDepthV2.from_config(CFG, device="cpu", dtype=torch.bfloat16)
    tb.load_state_dict(sd)
    w, b = tb._fp32_masters["blocks.3.attn.qkv"]
    assert torch.equal(w, sd["pixel_encoder.blocks.3.attn.qkv.weight"])
    assert torch.equal(b, sd["pixel_encoder.blocks.3.attn.qkv.bias"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_build_skips_a_master_its_parameter_left(models, dtype):
    """A weight written in place after load_state_dict no longer matches its
    master: an fp32 model quantizes the live value, a bf16 one raises."""
    jm, _ = models
    tm = UniDepthV2.from_config(CFG, device="cpu")
    tm.load_state_dict(from_jax_params(jm.params, CFG))
    tm.to(dtype).set_serving_precision("int8")
    fc2 = tm.pixel_encoder.blocks[1].mlp.fc2
    with torch.no_grad():
        fc2.weight.add_(0.01)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="no fp32 master that matches"):
            tm._serving_encoder()
        return
    layer = tm._serving_encoder().blocks[1].mlp.fc2
    q_ref, s_ref = quantize_kernel(fc2.weight)
    torch.testing.assert_close(layer.weight, q_ref, rtol=0, atol=0)
    torch.testing.assert_close(layer.scale, s_ref, rtol=0, atol=0)


def test_calibrate_int8_stages_matches_jax(models, rgb):
    jm, tm = models
    try:
        rep_j = jm.calibrate_int8_stages(rgb[:1], max_rel_err=0.02)
        rep_t = tm.calibrate_int8_stages(rgb[:1], max_rel_err=0.02)
    finally:
        for m in models:
            _serve(m, "default")
    assert rep_t["selected"] == rep_j["selected"]
    assert 0 < sum(rep_t["selected"]) < 4  # the budget excludes a stage
    assert [i for i, _ in rep_t["per_stage"]] == [i for i, _ in rep_j["per_stage"]]
    np.testing.assert_allclose(
        [e for _, e in rep_t["per_stage"]], [e for _, e in rep_j["per_stage"]], rtol=2e-2
    )
    assert rep_t["rel_err"] <= 0.02
    with pytest.raises(ValueError, match="no encoder stage"):
        try:
            tm.calibrate_int8_stages(rgb[:1], max_rel_err=1e-9)
        finally:
            _serve(tm, "default")


def test_set_serving_precision_contract(models, rgb):
    jm, tm = models
    with pytest.raises(ValueError, match="unknown serving precision"):
        tm.set_serving_precision("int4")
    before = tm.infer(rgb)["depth"]
    try:
        tm.set_serving_precision("int8")
        enc = tm._serving_encoder()
        assert tm._serving_encoder() is enc  # built once per (weights, mask)
        assert "pixel_encoder.blocks.0.attn.qkv.weight" in tm.state_dict()
        assert not any(k.endswith(".scale") for k in tm.state_dict())  # the checkpoint is untouched
        q = tm.infer(rgb)["depth"]
        assert not torch.equal(q, before)
        # new weights rebuild the int8 encoder from the new fp32 values
        rng = np.random.default_rng(2)
        new = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), jm.params
        )
        sd = from_jax_params(new, CFG)
        tm.load_state_dict(sd)
        enc2 = tm._serving_encoder()
        assert enc2 is not enc
        q_ref, s_ref = quantize_kernel(sd["pixel_encoder.blocks.2.attn.proj.weight"])
        torch.testing.assert_close(enc2.blocks[2].attn.proj.weight, q_ref, rtol=0, atol=0)
        torch.testing.assert_close(enc2.blocks[2].attn.proj.scale, s_ref, rtol=0, atol=0)
        tm._int8_stages = MASK
        assert tm._serving_encoder() is not enc2  # so does a new mask
    finally:
        tm.load_state_dict(from_jax_params(jm.params, CFG))
        _serve(tm, "default")
    after = tm.infer(rgb)["depth"]
    torch.testing.assert_close(after, before, rtol=0, atol=0)


def test_int8_requires_a_vit_encoder_and_calibration_where_asked():
    class Wrapper(ServingPrecisionMixin, nn.Module):
        def __init__(self, encoder):
            super().__init__()
            self.pixel_encoder = encoder
            self._init_serving()

    with pytest.raises(ValueError, match="int8 serving requires a ViT encoder"):
        Wrapper(nn.Identity()).set_serving_precision("int8")

    class ExpHead(Wrapper):
        INT8_REQUIRES_CALIBRATION = True

    m = ExpHead(DinoViT(ViTConfig(embed_dim=32, depth=2, num_heads=2, output_idx=(1, 2))))
    with pytest.raises(ValueError, match="calibrate_int8_stages"):
        m.set_serving_precision("int8")
    m._int8_stages = (True, False)
    m.set_serving_precision("int8")
    assert m.serving_precision == "int8"
    with pytest.raises(ValueError, match="has 3 entries"):
        m.pixel_encoder.quantize((True, False, True))
    assert [b.quant for b in m._serving_encoder().blocks] == [True, False]

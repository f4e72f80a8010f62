"""The port's int8 quantization (unidepth_tpu_torch/ops/quant.py) against the
JAX package's (unidepth_tpu/ops/quant.py) on the CPU, on numpy-seeded inputs.

Weight and activation codes and scales are held bit for bit (both packages
round half to even, clip to +-127 and floor the scale at 1e-12); the int8
dense layer to 1e-5 relative (its int32 product is exact, the fp32 dequant
epilogue may round in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.models.backbones.dinov2 import DinoViT as JDinoViT
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.ops.quant import QuantDense
from unidepth_tpu.ops.quant import dynamic_quant as j_dynamic_quant
from unidepth_tpu.ops.quant import quantize_dense_tree
from unidepth_tpu.ops.quant import quantize_kernel as j_quantize_kernel
from unidepth_tpu_torch.io.convert import encoder_state_dict
from unidepth_tpu_torch.models.backbones.dinov2 import DinoViT, ViTConfig
from unidepth_tpu_torch.ops.quant import (
    QuantLinear,
    dynamic_quant,
    int8_matmul,
    quantize_kernel,
    quantize_linear_tree,
)


@pytest.mark.parametrize("shape", [(64, 32), (3, 48, 24)], ids=["dense", "stacked"])
def test_quantize_kernel_matches_jax(shape):
    """JAX kernels are (..., K, N); the port's weights (..., N, K). One
    output channel is all zeros: scale 1e-12, codes 0."""
    k = (np.random.default_rng(0).standard_normal(shape) * 0.1).astype(np.float32)
    k[..., 5] = 0.0
    qj, sj = j_quantize_kernel(jnp.asarray(k))
    qt, st = quantize_kernel(torch.from_numpy(np.swapaxes(k, -1, -2).copy()))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(qt.numpy(), -1, -2), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (qt[..., 5, :] == 0).all() and (st[..., 5] == np.float32(1e-12)).all()


def test_dynamic_quant_matches_jax():
    x = (np.random.default_rng(1).standard_normal((2, 5, 33)) * 10.0).astype(np.float32)
    x[1, 2] = 0.0  # an all-zero row must not divide by zero
    qj, sj = j_dynamic_quant(jnp.asarray(x))
    qt, st = dynamic_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (qt[1, 2] == 0).all() and np.isfinite(st.numpy()).all()


@pytest.mark.parametrize("lead", [(17,), (3,), (2, 5)], ids=["m17", "m3-padded", "batched"])
def test_quant_linear_matches_quant_dense(lead):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((*lead, 48)).astype(np.float32)
    kernel = (rng.standard_normal((48, 24)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(24) * 0.01).astype(np.float32)
    qtree = quantize_dense_tree({"qkv": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}})["qkv"]
    ref = np.asarray(QuantDense(24, dtype=jnp.float32).apply({"params": qtree}, jnp.asarray(x)))
    layer = QuantLinear.from_float(torch.from_numpy(kernel.T.copy()), torch.from_numpy(bias))
    out = layer(torch.from_numpy(x))
    assert out.shape == (*lead, 24) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_int8_matmul_is_exact_and_pads_small_m():
    rng = np.random.default_rng(4)
    for m in (1, 16, 17, 40):
        xq = torch.from_numpy(rng.integers(-127, 128, (m, 32), dtype=np.int8))
        wq = torch.from_numpy(rng.integers(-127, 128, (24, 32), dtype=np.int8))
        out = int8_matmul(xq, wq)
        assert out.dtype == torch.int32 and out.shape == (m, 24)
        torch.testing.assert_close(out, xq.int() @ wq.int().T, rtol=0, atol=0)


def test_quant_linear_keeps_its_dtypes_under_a_cast():
    """``module.to(torch.bfloat16)`` casts float parameters; QuantLinear's
    int8 weight and fp32 scale and bias stay as they are."""
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((16, 32)).astype(np.float32))
    layer = QuantLinear.from_float(w, torch.full((16,), 0.1))
    scale = layer.scale.clone()
    holder = nn.Sequential(nn.Linear(32, 16), layer).to(torch.bfloat16)
    assert holder[0].weight.dtype == torch.bfloat16
    assert (layer.weight.dtype, layer.scale.dtype, layer.bias.dtype) == (torch.int8, torch.float32, torch.float32)
    torch.testing.assert_close(layer.scale, scale, rtol=0, atol=0)
    y = layer(torch.ones(20, 32, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16  # the output takes the input's dtype


DIM, DEPTH, HEADS, POS = 128, 4, 2, 8


@pytest.fixture(scope="module")
def encoders():
    kw = dict(embed_dim=DIM, depth=DEPTH, num_heads=HEADS, pos_embed_size=POS, output_idx=(2, 4), use_norm=True)
    img = np.zeros((1, 56, 70, 3), np.float32)
    params = JDinoViT(cfg=JViTConfig(**kw), dtype=jnp.float32).init(jax.random.PRNGKey(0), jnp.asarray(img))["params"]
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    tenc = DinoViT(ViTConfig(**kw))
    tenc.load_state_dict(encoder_state_dict(params))
    return params, tenc


@pytest.mark.parametrize("mask", [True, (False, True)], ids=["blanket", "stage_1"])
def test_quantized_encoder_weights_match_quantize_dense_tree(encoders, mask):
    """The swapped encoder's int8 weights, scales and biases equal JAX
    ``quantize_dense_tree`` of the same fp32 weights bit for bit, in the
    selected stages only; everything else is the original, shared."""
    params, tenc = encoders
    stages = None if mask is True else {"stage_1"}
    qp = quantize_dense_tree(params, stages=stages)
    qenc = tenc.quantize(mask)
    per_stage = DEPTH // 2
    for i, (blk, orig) in enumerate(zip(qenc.blocks, tenc.blocks)):
        si, j = divmod(i, per_stage)
        assert blk.quant == (mask is True or si == 1)
        assert not orig.quant
        for name, layer in (("qkv", blk.attn.qkv), ("proj", blk.attn.proj), ("fc1", blk.mlp.fc1), ("fc2", blk.mlp.fc2)):
            ref = qp[f"stage_{si}"][name]
            if not blk.quant:
                assert blk is orig and np.asarray(ref["kernel"]).dtype == np.float32
                continue
            assert isinstance(layer, QuantLinear)
            np.testing.assert_array_equal(layer.weight.numpy().T, np.asarray(ref["kernel"][j]))
            np.testing.assert_array_equal(layer.scale.numpy(), np.asarray(ref["scale"][j]))
            np.testing.assert_array_equal(layer.bias.numpy(), np.asarray(ref["bias"][j]))
        assert blk.norm1 is orig.norm1 and blk.ls1 is orig.ls1
    assert qenc.patch_embed is tenc.patch_embed and qenc.pos_embed is tenc.pos_embed


def test_quantize_linear_tree_leaves_the_original(encoders):
    _, tenc = encoders
    before = {k: v.clone() for k, v in tenc.state_dict().items()}
    qenc = quantize_linear_tree(tenc, prefixes=("blocks.3.",))
    assert isinstance(qenc.blocks[3].mlp.fc2, QuantLinear)
    assert all(isinstance(b.attn.qkv, nn.Linear) for b in tenc.blocks)
    assert qenc.blocks[0] is tenc.blocks[0] and qenc.blocks[3] is not tenc.blocks[3]
    assert set(tenc.state_dict()) == set(before)
    for k, v in tenc.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert quantize_linear_tree(tenc, prefixes=("nowhere.",)) is tenc

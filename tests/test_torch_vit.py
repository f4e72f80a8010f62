"""The port's DINOv2 encoder against the JAX package on shared weights
(fp32, CPU, rtol/atol 1e-4 as tests/test_v2_parity.py holds the JAX encoder
to the torch oracle). Weights: JAX init plus seeded numpy noise, carried to
the port through ``encoder_state_dict``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.models.backbones.dinov2 import DinoViT as JDinoViT
from unidepth_tpu.models.backbones.dinov2 import ViTBlock as JViTBlock
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.ops.flash_attention import safe_attention
from unidepth_tpu_torch.io.convert import encoder_state_dict
from unidepth_tpu_torch.models.backbones.dinov2 import DinoViT, ViTConfig

DIM, DEPTH, HEADS, POS = 128, 4, 2, 8
H, W = 56, 70  # 4 x 5 patch grid: the 8 x 8 pos-embed grid is resized bicubically
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def encoders():
    kw = dict(embed_dim=DIM, depth=DEPTH, num_heads=HEADS, pos_embed_size=POS, output_idx=(2, 4), use_norm=True)
    jenc = JDinoViT(cfg=JViTConfig(**kw), dtype=jnp.float32)
    img = np.random.default_rng(0).standard_normal((2, H, W, 3)).astype(np.float32)
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params
    )
    tenc = DinoViT(ViTConfig(**kw))
    tenc.load_state_dict(encoder_state_dict(params))
    return jenc, params, tenc, img


def test_vit_block_matches_jax_fused_block(encoders):
    """The port's block (K1 + K2 plain versions) against the JAX fused block
    (scale-folded qkv, Pallas ln_dense and QKV-direct attention in interpret
    mode)."""
    _, params, tenc, _ = encoders
    blk_params = jax.tree_util.tree_map(lambda a: a[0], params["stage_0"])
    x = (np.random.default_rng(2).standard_normal((2, 140, DIM)) * 0.5).astype(np.float32)
    with safe_attention():
        ref, _ = JViTBlock(dim=DIM, num_heads=HEADS, fused="on", dtype=jnp.float32).apply(
            {"params": blk_params}, jnp.asarray(x)
        )
    with torch.no_grad():
        out = tenc.blocks[0](torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dinovit_matches_jax(encoders):
    jenc, params, tenc, img = encoders
    feats_j, cls_j = jenc.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        feats_t, cls_t = tenc(torch.from_numpy(img))
    assert len(feats_t) == len(feats_j) == 2
    for ft, fj in zip(feats_t, feats_j):
        assert ft.shape == (2, H // 14, W // 14, DIM)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
    for ct, cj in zip(cls_t, cls_j):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)

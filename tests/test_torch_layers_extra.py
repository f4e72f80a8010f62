"""The port's ``AttentionDecoderBlock`` and ``normalize_coords`` against the
JAX package's on the CPU. The block runs in fp32 on the JAX block's weights
(its init plus seeded noise, so no LayerNorm is the identity and no
LayerScale is 1) carried by ``io.convert._attention_decoder_block``, at the
tolerance of the port's decoder parity tests (tests/test_torch_decoder.py:
rtol and atol 1e-4): dim 64 and 4 heads, with and without a context of its
own width and positional embeddings, single- and multi-head
cross-attention, cosine attention, the gated MLP, LayerScale 0 and 1, and an
attention bias. ``normalize_coords`` is held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.geometry.coords import coords_grid as j_coords_grid
from unidepth_tpu.geometry.coords import normalize_coords as j_normalize_coords
from unidepth_tpu.nn.layers import AttentionDecoderBlock as JBlock
from unidepth_tpu_torch.geometry.coords import coords_grid, normalize_coords
from unidepth_tpu_torch.io.convert import _attention_decoder_block
from unidepth_tpu_torch.nn.layers import AttentionDecoderBlock

DIM, HEADS, B, N, NCTX, CTX_DIM = 64, 4, 2, 11, 7, 48
TOL = dict(rtol=1e-4, atol=1e-4)

CASES = {
    "self": {},
    "context_pos": {"context": True, "pos": True},
    "multi_head_ca": {"single_head_ca": False, "context": True, "pos": True},
    "cosine": {"cosine": True, "context": True},
    "gated": {"gated": True, "pos": True},
    "no_layer_scale": {"layer_scale": 0.0, "context": True},
    "attn_bias": {"bias": True, "single_head_ca": False},
    "all": {"cosine": True, "gated": True, "single_head_ca": False, "context": True, "pos": True},
}


@pytest.mark.parametrize("case", list(CASES))
def test_attention_decoder_block_matches_jax(case):
    spec = CASES[case]
    kw = {k: spec[k] for k in ("cosine", "gated", "layer_scale", "single_head_ca") if k in spec}
    context_dim = CTX_DIM if spec.get("context") else None
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = rng.standard_normal((B, N, DIM)).astype(np.float32)
    inputs = {}
    if spec.get("context"):
        inputs["context"] = rng.standard_normal((B, NCTX, CTX_DIM)).astype(np.float32)
    if spec.get("pos"):
        inputs["pos_embed"] = rng.standard_normal((B, N, DIM)).astype(np.float32)
        if spec.get("context"):
            inputs["pos_embed_context"] = rng.standard_normal((B, NCTX, DIM)).astype(np.float32)
    if spec.get("bias"):  # both attentions take it: (B, 1, N, N) over one head or all
        inputs["attn_bias"] = rng.standard_normal((B, 1, N, N)).astype(np.float32)
    jblock = JBlock(dim=DIM, num_heads=HEADS, context_dim=context_dim, dtype=jnp.float32, **kw)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x), **jin)["params"]
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                                    params)
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(x), **jin))

    block = AttentionDecoderBlock(DIM, num_heads=HEADS, context_dim=context_dim, **kw)
    sd = {}
    _attention_decoder_block(sd, "block", params)
    block.load_state_dict({k.removeprefix("block."): v for k, v in sd.items()})  # strict: every key carried
    with torch.no_grad():
        out = block(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in inputs.items()})
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("h,w", [(2, 3), (37, 61), (375, 1242)])
def test_normalize_coords_matches_jax(h, w):
    grid = np.array(j_coords_grid(h, w))  # one grid for both (jnp.linspace's centres are ulps off k + 0.5)
    got = normalize_coords(torch.from_numpy(grid), h, w).numpy()
    want = np.asarray(j_normalize_coords(jnp.asarray(grid), h, w))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(normalize_coords(coords_grid(h, w), h, w).numpy(), want, rtol=0, atol=1e-6)
    batched = np.random.default_rng(h).uniform(0, max(h, w), (3, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(normalize_coords(torch.from_numpy(batched), h, w).numpy(),
                                  np.asarray(j_normalize_coords(jnp.asarray(batched), h, w)))

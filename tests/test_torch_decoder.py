"""The port's V2 decoder against the JAX package on shared weights (fp32,
CPU, rtol/atol 1e-4), with predicted rays and with given rays. Weights: JAX
init plus seeded numpy noise, carried through ``decoder_state_dict``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidepth_tpu.models.unidepthv2.decoder import Decoder as JDecoder
from unidepth_tpu_torch.io.convert import decoder_state_dict
from unidepth_tpu_torch.models.unidepthv2.decoder import Decoder

DIM, HIDDEN, HEADS, OUT_DIM, DEPTHS = 128, 64, 2, 16, (1, 1, 1)
H, W, GH, GW = 56, 70, 4, 5
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def decoders():
    kw = dict(input_dims=(DIM,) * 4, hidden_dim=HIDDEN, num_heads=HEADS, depths=DEPTHS, out_dim=OUT_DIM)
    jdec = JDecoder(dtype=jnp.float32, **kw)
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((2, GH, GW, DIM)).astype(np.float32) for _ in range(4)]
    cls = [rng.standard_normal((2, 1, DIM)).astype(np.float32) for _ in range(4)]
    params = jdec.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats], [jnp.asarray(c) for c in cls], (H, W))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params["params"]
    )
    tdec = Decoder(**kw)
    tdec.load_state_dict(decoder_state_dict(params, len(DEPTHS)))
    return jdec, params, tdec, feats, cls


@pytest.mark.parametrize("given_rays", [False, True])
def test_decoder_matches_jax(decoders, given_rays):
    jdec, params, tdec, feats, cls = decoders
    rays = None
    if given_rays:
        rays = np.random.default_rng(1).standard_normal((2, H * W, 3)).astype(np.float32)
        rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    ref = jdec.apply(
        {"params": params}, [jnp.asarray(f) for f in feats], [jnp.asarray(c) for c in cls], (H, W),
        rays_gt=None if rays is None else jnp.asarray(rays),
    )
    with torch.no_grad():
        out = tdec(
            [torch.from_numpy(f) for f in feats], [torch.from_numpy(c) for c in cls], (H, W),
            rays_gt=None if rays is None else torch.from_numpy(rays),
        )
    assert set(out) == set(ref)
    for key in ref:
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), err_msg=key, **TOL)


def test_decoder_skips_confidence_head(decoders):
    _, _, tdec, feats, cls = decoders
    args = ([torch.from_numpy(f) for f in feats], [torch.from_numpy(c) for c in cls], (H, W))
    with torch.no_grad():
        full = tdec(*args)
        part = tdec(*args, confidence=False)
    assert "confidence" not in part
    torch.testing.assert_close(part["radius"], full["radius"], rtol=0, atol=0)

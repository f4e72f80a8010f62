"""The port's ``UniDepthV2.infer()`` against the JAX ``UniDepthV2.infer()``
on shared weights (fp32, CPU): without a camera, with a K, and with an
aspect ratio that gets padded. Depth is held to max relative error < 1e-3
(the repo's end-to-end contract, docs/PARITY.md), intrinsics to rtol 1e-4.
A small model (C=128, 4 blocks, 2 heads) and a shrunk pixel budget keep it
quick, as tests/test_v2_infer.py does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.models.unidepthv2.model import UniDepthV2 as JUniDepthV2
from unidepth_tpu_torch.io.convert import from_jax_params
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2, "expansion": 4, "layer_scale": 1.0,
        "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 1, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 128, "depth": 4, "num_heads": 2,
            "pos_embed_size": 8, "output_idx": [1, 2, 3, 4], "use_norm": True,
        },
        "attention_logit_bound": 12.5,
    },
    "data": {"augmentations": {"shape_constraints": {
        "ratio_bounds": [0.5, 2.5], "pixels_min": 4000, "pixels_max": 10000}}},
}


# resolution_level is left unset: both packages warn and take the default budget
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
    return jm, tm


K = np.array([[80.0, 0, 40.0], [0, 85.0, 30.0], [0, 0, 1]], np.float32)


@pytest.mark.parametrize(
    "shape,camera",
    [((2, 60, 90, 3), None), ((2, 56, 84, 3), K), ((1, 30, 100, 3), None)],  # last: ratio 3.3 -> padded
    ids=["predicted-camera", "given-K", "padded-aspect"],
)
def test_infer_matches_jax(models, shape, camera):
    jm, tm = models
    rgb = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    ref = jm.infer(rgb, camera=camera)
    out = tm.infer(rgb, camera=camera)
    assert set(out) == set(ref)
    for key in ref:
        assert tuple(out[key].shape) == ref[key].shape, key
        assert out[key].dtype == torch.float32
    d_ref = np.asarray(ref["depth"])
    rel = np.abs(out["depth"].numpy() - d_ref) / np.abs(d_ref)
    assert rel.max() < 1e-3
    np.testing.assert_allclose(out["intrinsics"].numpy(), np.asarray(ref["intrinsics"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["rays"].numpy(), np.asarray(ref["rays"]), atol=1e-4)


def test_infer_outputs_subset_and_layouts(models):
    _, tm = models
    rgb = np.random.default_rng(7).integers(0, 256, (1, 56, 84, 3), dtype=np.uint8)
    full = tm.infer(rgb)
    sub = tm.infer(rgb, outputs=("depth", "intrinsics"))
    assert set(sub) == {"depth", "intrinsics"}
    torch.testing.assert_close(sub["depth"], full["depth"], rtol=0, atol=0)
    chw = tm.infer(torch.from_numpy(rgb[0]).permute(2, 0, 1))  # (3, H, W) input
    torch.testing.assert_close(chw["depth"], full["depth"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown infer outputs"):
        tm.infer(rgb, outputs=("depht",))


def test_shape_arithmetic_and_config(models):
    jm, tm = models
    assert tm.attention_logit_bound == 12.5
    assert tm.serving_shape_key((30, 100)) == jm.serving_shape_key((30, 100))
    assert next(tm.parameters()).dtype == torch.float32  # CPU compute dtype
    tm.resolution_level = 0
    lo = tm._pixels_bounds()
    tm.resolution_level = 9
    assert tm._pixels_bounds()[0] > lo[0]
    tm.resolution_level = None

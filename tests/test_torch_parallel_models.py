"""The port's models over two processes (gloo, CPU) against the JAX
package's single-process forwards on shared weights (the port's init plus
seeded noise, carried to JAX by the reference-schema converters).

* Tensor parallelism, tp=2 (``parallel.tp.shard_model_``): ``encode_decode``
  of UniDepthV1 with DINOv2 (C = 64, 4 blocks, 2 heads; decoder hidden 32,
  4 heads, so its one-head attentions stay whole) and with ConvNeXt (depths
  (1, 1, 2, 1), dims 32-256), and of UniDepthV2old (decoder hidden 32, 2
  heads). V1: depth max relative error < 1e-3, the other outputs rtol 1e-4
  (atol 1e-4 scaled by the largest value), tests/test_torch_v1.py's gates;
  V2old: depth at rtol 5e-3, the JAX package's fp32 bound where V2old's
  whole-map norm amplifies rounding (tests/test_torch_v2old.py), K and
  points rtol 1e-4.
* Batch-sharded serving over data=2 (``parallel.mesh.batch_sharded``): a
  small UniDepthV2's ``encode_decode`` and ``infer()`` of 4 images, each
  rank on 2, the outputs all-gathered, against JAX's on all 4 at the same
  gates as V1's.
* ``validate()`` with the 3-D metrics at two ranks over a Dummy set of 5
  (odd: the shards hold 3 and 2, each padded to 2 batches of 2) against
  JAX's one-process ``validate()`` of the same 5 images,
  tests/test_torch_validation.py's gates.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_worker import forwards_and_serving, spawn
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.geometry.rays import generate_rays as j_generate_rays
from unidepth_tpu.io.convert import convert_convnext, convert_v1_decoder, convert_v1_state_dict
from unidepth_tpu.io.convert import convert_v2_state_dict, convert_v2old_state_dict
from unidepth_tpu.models.backbones.convnext import ConvNeXt as JConvNeXt
from unidepth_tpu.models.backbones.convnext import ConvNeXtConfig as JConvNeXtConfig
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.models.unidepthv1.model import UniDepthV1 as JUniDepthV1
from unidepth_tpu.models.unidepthv2.model import UniDepthV2 as JUniDepthV2
from unidepth_tpu.models.unidepthv2.old import UniDepthV2old as JUniDepthV2old
from unidepth_tpu.utils.validation import validate as j_validate
from unidepth_tpu_torch.datasets.dummy import Dummy
from unidepth_tpu_torch.datasets.loader import eval_batches
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old
from unidepth_tpu_torch.utils.evaluation import DEPTH_METRICS

pytestmark = pytest.mark.filterwarnings("ignore:resolution_level not set")

V1_VIT_CFG = {
    "model": {"name": "UniDepthV1", "num_heads": 4, "expansion": 4,
              "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
              "pixel_encoder": {"name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2,
                                "pos_embed_size": 8, "output_idx": [1, 2, 3, 4]}},
    "data": {"image_shape": [56, 70]},
}
V1_VIT = dict(embed_dim=64, depth=4, num_heads=2, pos_embed_size=8, output_idx=(1, 2, 3, 4), use_norm=False,
              interpolate_offset=0.1)
CNX_DEPTHS, CNX_DIMS = (1, 1, 2, 1), (32, 64, 128, 256)
V1_CNX_CFG = {
    "model": {"name": "UniDepthV1", "num_heads": 4, "expansion": 4,
              "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
              "pixel_encoder": {"name": "convnext_large", "depths": list(CNX_DEPTHS), "dims": list(CNX_DIMS)}},
    "data": {"image_shape": [64, 96]},
}
V2OLD_CFG = {
    "model": {"name": "UniDepthV2old", "num_heads": 2, "expansion": 4,
              "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
              "pixel_encoder": {"name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2,
                                "pos_embed_size": 8, "output_idx": [1, 2, 3, 4], "use_norm": True}},
    "data": {"image_shape": [56, 70]},
}
V2OLD_VIT = dict(embed_dim=64, depth=4, num_heads=2, pos_embed_size=8, output_idx=(1, 2, 3, 4), use_norm=True)
SHAPE = (56, 84)
V2_CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2, "expansion": 4, "layer_scale": 1.0,
        "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 1, 1]},
        "pixel_encoder": {"name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2, "pos_embed_size": 8,
                          "output_idx": [1, 2, 3, 4], "use_norm": True},
    },
    "data": {"image_shape": list(SHAPE), "augmentations": {"shape_constraints": {
        "ratio_bounds": [0.5, 2.5], "pixels_min": 4000, "pixels_max": 10000}}},
}
COUNTING = ("d1", "d2", "d3", "tau", "d_auc", "d1_ssi", "tau_ssi", "d1_si", "tau_si")
VAL_LENGTH, VAL_BATCH = 5, 2


def _noisy(model, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    sd = {k: (v.numpy() + scale * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd


def _parts(sd):
    return ({k.removeprefix("pixel_encoder."): v for k, v in sd.items() if k.startswith("pixel_encoder.")},
            {k.removeprefix("pixel_decoder."): v for k, v in sd.items() if k.startswith("pixel_decoder.")})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX models and inputs, and what the two ranks computed."""
    rng = np.random.default_rng(0)
    jax_models, tp_models = {}, {}

    v1 = UniDepthV1.from_config(V1_VIT_CFG, device="cpu").init_params(seed=0)
    sd = _noisy(v1, 1)
    j1 = JUniDepthV1(JViTConfig(**V1_VIT), hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=4,
                     image_shape=(56, 70), dtype=jnp.float32)
    j1.params = convert_v1_state_dict(sd, output_idx=(1, 2, 3, 4), backbone="dinov2", use_norm=False)
    rays = np.array(j_generate_rays(jnp.asarray(np.stack([np.array(
        [[60.0, 0, 33.0], [0, 62.0, 27.0], [0, 0, 1]], np.float32)] * 2)), (56, 70))[0])
    img = rng.standard_normal((2, 56, 70, 3)).astype(np.float32)
    tp_models["v1-vit"], jax_models["v1-vit"] = (v1, img, {"rays_gt": rays}), (j1, img, {"rays_gt": rays})

    cnx = UniDepthV1.from_config(V1_CNX_CFG, device="cpu").init_params(seed=0)
    enc, dec = _parts(_noisy(cnx, 2, 0.05))
    jenc = JConvNeXt(cfg=JConvNeXtConfig(depths=CNX_DEPTHS, dims=CNX_DIMS), stacking="max_cls", dtype=jnp.float32)
    jc = JUniDepthV1(None, hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=4, image_shape=(64, 96),
                     dtype=jnp.float32, encoder_module=jenc)
    jc.params = {"encoder": convert_convnext(enc, depths=CNX_DEPTHS), "decoder": convert_v1_decoder(dec)}
    img = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    tp_models["v1-convnext"], jax_models["v1-convnext"] = (cnx, img, {}), (jc, img, {})

    old = UniDepthV2old.from_config(V2OLD_CFG, device="cpu").init_params(seed=0)
    sd = _noisy(old, 3)
    jo = JUniDepthV2old(JViTConfig(**V2OLD_VIT), hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=2,
                        dtype=jnp.float32)
    jo.params = convert_v2old_state_dict(sd, output_idx=(1, 2, 3, 4), use_norm=True)
    img = rng.standard_normal((2, 56, 70, 3)).astype(np.float32)
    tp_models["v2old"], jax_models["v2old"] = (old, img, {}), (jo, img, {})

    v2 = UniDepthV2.from_config(V2_CFG, device="cpu").init_params(seed=0)
    sd = _noisy(v2, 4)
    j2 = JUniDepthV2.from_config(V2_CFG, dtype=jnp.float32)
    j2.params = convert_v2_state_dict(sd, output_idx=(1, 2, 3, 4), num_levels=3, use_norm=True)
    image = rng.standard_normal((4, *SHAPE, 3)).astype(np.float32)
    rgbs = rng.integers(0, 256, (4, *SHAPE, 3), dtype=np.uint8)
    dataset = Dummy(image_shape=SHAPE, length=VAL_LENGTH)
    ranks = spawn(forwards_and_serving, tmp_path_factory.mktemp("parallel_models"), tp_models, v2, image, rgbs,
                  dataset, VAL_BATCH)
    return {"jax": jax_models, "v2": (j2, image, rgbs, dataset), "ranks": ranks}


def _depth_and_rest(out: dict, ref: dict, depth_rtol: float, keys=None):
    d_ref = np.asarray(ref["depth"])
    got = out["depth"].numpy()
    assert got.shape == d_ref.shape
    assert (np.abs(got - d_ref) / np.abs(d_ref)).max() < depth_rtol
    for key in keys if keys is not None else [k for k in out if k != "depth" and k in ref]:
        want = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].numpy(), want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=key)


@pytest.mark.parametrize("name", ["v1-vit", "v1-convnext", "v2old"])
def test_tp2_forward_matches_jax(runs, name):
    jm, img, kwargs = runs["jax"][name]
    fwd = jax.jit(lambda p, x, kw: jm.encode_decode(p, x, **kw))  # eager flax runs op by op: minutes
    ref = fwd(jm.params, jnp.asarray(img), {k: jnp.asarray(v) for k, v in kwargs.items()})
    a, b = (r["tp"][name] for r in runs["ranks"])
    assert a["split"] == b["split"] and a["split"]
    for k in a["outputs"]:
        assert torch.equal(a["outputs"][k], b["outputs"][k]), k  # tp ranks hold the same outputs
    if name == "v2old":
        _depth_and_rest(a["outputs"], ref, 5e-3, keys=("K", "points"))
    else:
        _depth_and_rest(a["outputs"], ref, 1e-3)
    modules = {n.rsplit(".", 2)[-2] for n in a["split"]}
    assert {"proj1", "proj2", "q", "kv", "out"} <= modules
    assert {"fc1", "fc2"} <= modules if name == "v1-convnext" else {"qkv", "proj", "fc1", "fc2"} <= modules
    if name.startswith("v1"):
        # the one-head D = 32 aggregate attentions stay whole
        assert not any(".aggregate" in n and n.rsplit(".", 2)[-2] in ("q", "kv", "out") for n in a["split"])


def test_batch_sharded_encode_decode_and_infer_match_jax(runs):
    j2, image, rgbs, _ = runs["v2"]
    a, b = runs["ranks"]
    ref = jax.jit(j2.encode_decode)(j2.params, jnp.asarray(image))
    for k in a["encode_decode"]:
        assert torch.equal(a["encode_decode"][k], b["encode_decode"][k]), k
    assert a["encode_decode"]["depth"].shape[0] == 4
    _depth_and_rest(a["encode_decode"], ref, 1e-3, keys=("rays", "intrinsics"))
    ref = j2.infer(rgbs)
    assert a["infer"]["depth"].shape == (4, *SHAPE, 1)
    _depth_and_rest(a["infer"], ref, 1e-3, keys=("intrinsics", "points"))


def test_two_rank_validate_matches_jax(runs):
    j2, _, _, dataset = runs["v2"]
    a, b = runs["ranks"]
    assert a["val"] == b["val"]
    assert [m.tolist() for m in a["pad_masks"]] == [[True, True], [True, False]]  # indices 0, 2 | 4, (4)
    assert [m.tolist() for m in b["pad_masks"]] == [[True, True], [False, False]]  # indices 1, 3 | (3, 3)
    want = j_validate(j2, j2.params, {"Dummy": eval_batches(dataset, VAL_BATCH)}, with_3d=True,
                      depth_ranges={"Dummy": (0.1, 10.0)})["Dummy"]
    got = a["val"]["Dummy"]
    assert set(got) == set(want) == {*DEPTH_METRICS, "chamfer", "F1"}
    n_valid = SHAPE[0] * SHAPE[1]
    for k in got:
        assert np.isfinite(got[k]), k
        if k in COUNTING:
            assert abs(got[k] - want[k]) <= 1.0 / n_valid + 1e-9, (k, got[k], want[k])
        elif k == "F1":
            assert abs(got[k] - want[k]) <= 2.0 / n_valid + 1e-9, (k, got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)

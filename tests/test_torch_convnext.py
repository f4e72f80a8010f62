"""The port's ConvNeXt encoder and UniDepthV1 with it against the JAX
package on shared weights (fp32, CPU, where JAX takes its unfused paths).

The encoder (depths (1, 1, 2, 1), dims (32, 64, 128, 256), as in the JAX
V1 tests) with GRN off and on at 1e-4. The whole model
(decoder hidden 32, depths (1, 1, 1), network shape 64 x 96) without a
camera, with a K and with an aspect ratio that gets padded: depth max
relative error < 1e-3 (docs/PARITY.md), intrinsics and points rtol 1e-4.
Its ``max_cls`` tokens have mixed widths (64, 128, 128, 256), so the token
adapters are sized from the encoder. Then the weight converter and the
route of each block's LN -> fc1 -> GELU to kernel K2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.io.convert import convert_convnext, convert_v1_decoder
from unidepth_tpu.models.backbones.convnext import ConvNeXt as JConvNeXt
from unidepth_tpu.models.backbones.convnext import ConvNeXtConfig as JConvNeXtConfig
from unidepth_tpu.models.unidepthv1.model import UniDepthV1 as JUniDepthV1
from unidepth_tpu_torch.io.convert import convnext_state_dict, from_jax_params
from unidepth_tpu_torch.models.backbones.convnext import ConvNeXt, ConvNeXtConfig
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.nn import layers as layers_module

DEPTHS, DIMS = (1, 1, 2, 1), (32, 64, 128, 256)
CFG = {
    "model": {
        "name": "UniDepthV1", "num_heads": 4, "expansion": 4,
        "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
        "pixel_encoder": {"name": "convnext_large", "depths": list(DEPTHS), "dims": list(DIMS)},
    },
    "data": {"image_shape": [64, 96]},
}


def _noisy(params, seed):
    """JAX init plus seeded noise: the layer scales (1e-6) and GRN (zeros)
    would otherwise hide every block's branch."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)


@pytest.mark.parametrize("use_grn", [False, True], ids=["convnext", "convnext-v2-grn"])
def test_convnext_encoder_matches_jax(use_grn):
    """The ``max_cls`` stacking V1 uses: per-stage maxima and the tokens of
    the last four blocks."""
    img = np.random.default_rng(0).standard_normal((2, 64, 96, 3)).astype(np.float32)
    jenc = JConvNeXt(cfg=JConvNeXtConfig(depths=DEPTHS, dims=DIMS, use_grn=use_grn), stacking="max_cls",
                     dtype=jnp.float32)
    params = _noisy(jax.jit(jenc.init)(jax.random.PRNGKey(0), jnp.asarray(img))["params"], 1)
    tenc = ConvNeXt(ConvNeXtConfig(DEPTHS, DIMS, use_grn))
    tenc.load_state_dict(convnext_state_dict(params))  # strict: GRN present exactly when used
    feats_j, toks_j = jax.jit(jenc.apply)({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        feats_t, toks_t = tenc(torch.from_numpy(img))
    assert [tuple(f.shape) for f in feats_t] == [(2, 16 // 2**i, 24 // 2**i, d) for i, d in enumerate(DIMS)]
    assert [t.shape[-1] for t in toks_t] == [64, 128, 128, 256]
    for t, j in zip(feats_t + toks_t, list(feats_j) + list(toks_j)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


def _jit_init(jm, seed):
    """``UniDepthV1.init_params`` with both inits jitted (eager flax init is
    several times slower on the CPU)."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    img = jnp.zeros((1, *jm.image_shape, 3), jnp.float32)
    enc = jax.jit(jm.encoder.init)(k1, img)
    feats, cls_tokens = jax.eval_shape(jm.encoder.apply, enc, img)
    zeros = [[jnp.zeros(t.shape, jnp.float32) for t in ts] for ts in (feats, cls_tokens)]
    dec = jax.jit(jm.decoder.init, static_argnums=3)(k2, *zeros, jm.image_shape)
    return {"encoder": enc["params"], "decoder": dec["params"]}


@pytest.fixture(scope="module")
def models():
    jenc = JConvNeXt(cfg=JConvNeXtConfig(depths=DEPTHS, dims=DIMS), stacking="max_cls", dtype=jnp.float32)
    jm = JUniDepthV1(None, hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=4, image_shape=(64, 96),
                     dtype=jnp.float32, encoder_module=jenc)
    jm.params = _noisy(_jit_init(jm, 0), 2)
    tm = UniDepthV1.from_config(CFG, device="cpu")
    tm.load_state_dict(from_jax_params(jm.params, CFG))
    return jm, tm


KS = np.array([[[70.0, 0, 40.0], [0, 72.0, 30.0], [0, 0, 1]], [[50.0, 0, 38.0], [0, 55.0, 33.0], [0, 0, 1]]],
              np.float32)


@pytest.mark.parametrize(
    "shape,camera",
    [((2, 64, 96, 3), None), ((2, 60, 80, 3), KS), ((1, 30, 100, 3), None)],  # last: aspect 3.3 -> padded
    ids=["predicted-camera", "given-K", "padded-aspect"],
)
def test_convnext_infer_matches_jax(models, shape, camera):
    jm, tm = models
    rgb = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    K_before = None if camera is None else camera.copy()
    ref = jm.infer(rgb, intrinsics=camera)
    out = tm.infer(rgb, intrinsics=camera)
    if camera is not None:
        np.testing.assert_array_equal(camera, K_before)
    assert set(out) == set(ref) == {"depth", "points", "intrinsics"}
    for key in out:
        assert out[key].dtype == torch.float32 and tuple(out[key].shape) == ref[key].shape, key
    assert tuple(out["depth"].shape) == (*shape[:3], 1)
    d_ref = np.asarray(ref["depth"])
    assert (np.abs(out["depth"].numpy() - d_ref) / np.abs(d_ref)).max() < 1e-3
    np.testing.assert_allclose(out["intrinsics"].numpy(), np.asarray(ref["intrinsics"]), rtol=1e-4, atol=1e-4)
    p_ref = np.asarray(ref["points"])
    np.testing.assert_allclose(out["points"].numpy(), p_ref, rtol=1e-4, atol=1e-4 * np.abs(p_ref).max())


def test_round_trip_through_jax_layout_is_bit_exact():
    """reference schema -> convert_convnext + convert_v1_decoder (the JAX
    tree) -> from_jax_params: every key of the port's model, bit for bit, none
    missing and none left over."""
    model = UniDepthV1.from_config(CFG, device="cpu")
    rng = np.random.default_rng(3)
    sd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) for k, v in model.state_dict().items()}
    # convert_v1_state_dict's ConvNeXt takes ConvNeXt-L's depths; its two halves take any
    part = {root: {k.removeprefix(f"{root}."): v for k, v in sd.items() if k.startswith(f"{root}.")}
            for root in ("pixel_encoder", "pixel_decoder")}
    params = {"encoder": convert_convnext(part["pixel_encoder"], depths=DEPTHS),
              "decoder": convert_v1_decoder(part["pixel_decoder"])}
    back = from_jax_params(params, CFG)
    assert set(back) == set(model.state_dict())
    for key, value in back.items():
        assert torch.equal(value, torch.from_numpy(sd[key])), key
    model.load_state_dict(back)  # strict


@pytest.mark.parametrize(
    "name,levels,tokens",
    [("convnext_large", (192, 384, 768, 1536), (1536, 1536, 1536, 768)), ("dinov2_vitl14", (1024,) * 4, (1024,) * 4)],
)
def test_full_size_adapters_follow_the_encoder(name, levels, tokens):
    """At full width (on the meta device: no memory): the input adapters
    take each level's width, the token adapters the reversed token widths,
    ConvNeXt-L's stage 2 (768) last."""
    cfg = {"model": {"name": "UniDepthV1", "num_heads": 8, "pixel_decoder": {"hidden_dim": 512, "depths": [3, 2, 1]},
                     "pixel_encoder": {"name": name}}}
    with torch.device("meta"):
        model = UniDepthV1.from_config(cfg, device="meta")
    dec = model.pixel_decoder
    assert tuple(a[1].in_features for a in dec.input_adapter.input_adapters) == levels
    assert tuple(a[1].in_features for a in dec.token_adapter.input_adapters) == tokens


def test_convnext_routes_ln_gelu_by_shape(monkeypatch):
    """Each block's LN -> fc1 -> GELU goes to K2 (``ln_dense``) exactly when
    C % 32 == 0 and F % 128 == 0, else to its plain version."""
    calls = []

    def spy(name, fn):
        return lambda x, w, *rest: calls.append((name, x.shape[-1])) or fn(x, w, *rest)

    monkeypatch.setattr(layers_module, "ln_dense", spy("kernel", layers_module.ln_dense_plain))
    monkeypatch.setattr(layers_module, "ln_dense_plain", spy("plain", layers_module.ln_dense_plain))
    enc = ConvNeXt(ConvNeXtConfig((1, 1, 1, 1), (16, 32, 48, 64)))
    with torch.no_grad():
        enc(torch.zeros(1, 32, 32, 3))
    assert calls == [("plain", 16), ("kernel", 32), ("plain", 48), ("kernel", 64)]

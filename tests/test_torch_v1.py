"""The port's UniDepthV1 pieces and its DINOv2 ``infer()`` against the JAX
package on shared weights (fp32, CPU, where JAX takes its unfused paths).

Pieces: the sine position embedding, the degree-8 spherical harmonics, the
rays with their angles and the spherical z-buffer back-projection, the
offset-0.1 pos-embed resize and the ViT ``max_cls`` stacking at 1e-5;
Nystrom attention with the token count divisible and not divisible by the
landmarks, ``CvnxtBlock`` and ``ConvUpsample`` at 1e-4. ``encode_decode``
(the eval forward) with nothing given, with the GT rays, and with a K and
``skip_camera``. The whole model at
the JAX V1 tests' size (C = 64, 4 blocks, 2 heads, pos-embed 8; decoder
hidden 32, depths (1, 1, 1); network shape 56 x 70), without a camera,
with a K, with a K and ``skip_camera``, and with an aspect ratio that gets
padded: depth max relative error < 1e-3 (docs/PARITY.md), intrinsics and
points rtol 1e-4. Then the entry points, the weight converter and the
route of LN -> pwconv1 -> GELU to kernel K2.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unidepth_tpu.geometry.rays import generate_rays as j_generate_rays
from unidepth_tpu.geometry.rays import spherical_zbuffer_to_euclidean as j_spherical_zbuffer
from unidepth_tpu.io.convert import convert_v1_state_dict
from unidepth_tpu.models.backbones.dinov2 import DinoViT as JDinoViT
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.models.unidepthv1 import model as j_model_module
from unidepth_tpu.models.unidepthv1.model import UniDepthV1 as JUniDepthV1
from unidepth_tpu.nn.nystrom import nystrom_attention as j_nystrom
from unidepth_tpu.nn.upsample import ConvUpsample as JConvUpsample
from unidepth_tpu.nn.upsample import CvnxtBlock as JCvnxtBlock
from unidepth_tpu.ops.fourier import position_embedding_sine as j_position_embedding_sine
from unidepth_tpu.ops.resize import resize as j_resize
from unidepth_tpu.ops.sht import rsh_cart_8 as j_rsh_cart_8
from unidepth_tpu_torch.geometry.rays import generate_rays, spherical_zbuffer_to_euclidean
from unidepth_tpu_torch.io.convert import conv_upsample_state_dict, encoder_state_dict, from_jax_params
from unidepth_tpu_torch.models.backbones.dinov2 import DinoViT, ViTConfig
from unidepth_tpu_torch.models.unidepthv1 import model as model_module
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.nn import layers as layers_module
from unidepth_tpu_torch.nn.nystrom import nystrom_attention
from unidepth_tpu_torch.nn.upsample import ConvUpsample, CvnxtBlock
from unidepth_tpu_torch.ops.fourier import position_embedding_sine
from unidepth_tpu_torch.ops.resize import resize
from unidepth_tpu_torch.ops.sht import rsh_cart_8

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


def _close(t, j, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _noisy(params, seed):
    """JAX init plus seeded noise, so that zero-initialised biases, tokens
    and unit scales carry information through the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)


def jit_init(jm, seed):
    """``UniDepthV1.init_params`` with both inits jitted (eager flax init
    runs op by op: ~60 s on the CPU against ~18 s)."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    img = jnp.zeros((1, *jm.image_shape, 3), jnp.float32)
    enc = jax.jit(jm.encoder.init)(k1, img)
    feats, cls_tokens = jax.eval_shape(jm.encoder.apply, enc, img)
    zeros = [[jnp.zeros(t.shape, jnp.float32) for t in ts] for ts in (feats, cls_tokens)]
    dec = jax.jit(jm.decoder.init, static_argnums=3)(k2, *zeros, jm.image_shape)
    return {"encoder": enc["params"], "decoder": dec["params"]}


# ---- the pieces ----------------------------------------------------------------


@pytest.mark.parametrize("h,w,feats,normalize", [(4, 5, 16, True), (33, 44, 256, True), (6, 3, 8, False)])
def test_position_embedding_sine_matches_jax(h, w, feats, normalize):
    out = position_embedding_sine(h, w, num_pos_feats=feats, normalize=normalize)
    ref = j_position_embedding_sine(h, w, num_pos_feats=feats, normalize=normalize)
    assert out.shape == ref.shape == (h, w, 2 * feats)
    _close(out, ref)


def test_rsh_cart_8_matches_jax():
    v = np.random.default_rng(0).standard_normal((3, 50, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    out = rsh_cart_8(torch.from_numpy(v))
    assert out.shape == (3, 50, 81)
    _close(out, j_rsh_cart_8(jnp.asarray(v)))


def test_generate_rays_and_back_projection_match_jax():
    K = np.array([[[80.0, 0, 35.0], [0, 85.0, 28.0], [0, 0, 1]], [[60.0, 0, 20.0], [0, 55.0, 31.0], [0, 0, 1]]],
                 np.float32)
    rays, angles = generate_rays(torch.from_numpy(K), (21, 30))
    j_rays, j_angles = j_generate_rays(jnp.asarray(K), (21, 30))
    assert rays.shape == (2, 630, 3) and angles.shape == (2, 630, 2)
    _close(rays, j_rays)
    _close(angles, j_angles)
    z = np.random.default_rng(1).uniform(0.5, 20.0, (2, 630, 1)).astype(np.float32)
    sph = np.concatenate([np.asarray(j_angles), z], axis=-1)
    _close(spherical_zbuffer_to_euclidean(torch.from_numpy(sph)), j_spherical_zbuffer(jnp.asarray(sph)), atol=1e-5,
           rtol=1e-6)


@pytest.mark.parametrize("grid", [(4, 5), (33, 44), (37, 30)])
def test_offset_pos_embed_resize_matches_jax(grid):
    """Bicubic with scale factors (g + 0.1) / 37: the source grid at
    37 / (g + 0.1), not 37 / g. Without them the grid shifts by ~0.1/37,
    which 1e-5 sees."""
    x = np.random.default_rng(2).standard_normal((1, 37, 37, 16)).astype(np.float32)
    scales = tuple((g + 0.1) / 37 for g in grid)
    out = resize(torch.from_numpy(x), grid, mode="bicubic", scale_factors=scales)
    ref = j_resize(jnp.asarray(x), grid, mode="bicubic", scale_factors=scales)
    _close(out, ref)
    # torch's own scale_factor semantics, evaluated in float64
    exact = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2).double(), scale_factor=scales, mode="bicubic")
    _close(out, exact.permute(0, 2, 3, 1).float(), atol=1e-6)
    plain = resize(torch.from_numpy(x), grid, mode="bicubic")
    assert np.abs(plain.numpy() - np.asarray(ref)).max() > 1e-4  # the offset is visible at this tolerance


def test_resize_scale_factors_must_give_the_size():
    with pytest.raises(ValueError, match="scale factors"):
        resize(torch.zeros(1, 8, 8, 2), (4, 4), mode="bicubic", scale_factors=(0.4, 0.4))
    with pytest.raises(ValueError, match="bicubic only"):
        resize(torch.zeros(1, 8, 8, 2), (4, 4), mode="bilinear", scale_factors=(0.5, 0.5))


@pytest.mark.parametrize("n", [384, 320, 100], ids=["divisible", "not-divisible", "exact"])
def test_nystrom_attention_matches_jax(n):
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal((2, 2, n, 16)).astype(np.float32) * 0.5 for _ in range(3))
    out = nystrom_attention(*map(torch.from_numpy, (q, k, v)))
    _close(out, j_nystrom(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 128), atol=1e-4, rtol=1e-4)


def test_cvnxt_block_and_conv_upsample_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 7, 32)).astype(np.float32)
    up = JConvUpsample(32, dtype=jnp.float32)
    params = _noisy(up.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    sd = conv_upsample_state_dict(params)
    port_blk, port_up = CvnxtBlock(32), ConvUpsample(32)
    port_blk.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items() if k.startswith("convs.0.")})
    port_up.load_state_dict(sd)
    with torch.no_grad():
        blk, out = port_blk(torch.from_numpy(x)), port_up(torch.from_numpy(x))
    blk_ref = JCvnxtBlock(32, dtype=jnp.float32).apply({"params": params["convs_0"]}, jnp.asarray(x))
    _close(blk, blk_ref, atol=1e-4, rtol=1e-4)
    ref = up.apply({"params": params}, jnp.asarray(x))
    assert out.shape == ref.shape == (2, 4 * 42, 16)
    _close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def encoders():
    jenc = JDinoViT(cfg=JViTConfig(**VIT), stacking="max_cls", dtype=jnp.float32)
    img = np.random.default_rng(5).standard_normal((2, 56, 70, 3)).astype(np.float32)
    params = _noisy(jenc.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"], 6)
    tenc = DinoViT(ViTConfig(**VIT), stacking="max_cls")
    tenc.load_state_dict(encoder_state_dict(params))
    return jenc, params, tenc, img


def test_vit_max_cls_stacking_matches_jax(encoders):
    """Per stage the max over its blocks of patches + cls; the cls tokens of
    the last four blocks; the pos-embed resized with the offset 0.1."""
    jenc, params, tenc, img = encoders
    feats_j, cls_j = jenc.apply({"params": params}, jnp.asarray(img))
    with torch.no_grad():
        feats_t, cls_t = tenc(torch.from_numpy(img))
    assert len(feats_t) == len(cls_t) == 4
    for ft, fj in zip(feats_t, feats_j):
        assert ft.shape == (2, 4, 5, 64)
        _close(ft, fj)
    for ct, cj in zip(cls_t, cls_j):
        _close(ct, cj)


def test_vit_other_stackings_still_raise():
    """Every stacking mode of the JAX encoder builds (each is held to JAX in
    tests/test_torch_vit_extras.py); a name outside them raises, naming
    them."""
    assert DinoViT(ViTConfig(**VIT), stacking="max").stacking == "max"
    with pytest.raises(ValueError, match="max_cls"):
        DinoViT(ViTConfig(**VIT), stacking="median")


# ---- the whole model -----------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jm = JUniDepthV1(JViTConfig(**VIT), hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=4, image_shape=(56, 70),
                     dtype=jnp.float32)
    jm.params = _noisy(jit_init(jm, 0), 7)
    tm = UniDepthV1.from_config(CFG, device="cpu")
    tm.load_state_dict(from_jax_params(jm.params, CFG))
    return jm, tm


K = np.array([[60.0, 0, 33.0], [0, 62.0, 27.0], [0, 0, 1]], np.float32)
KS = np.stack([K, np.array([[45.0, 0, 30.0], [0, 50.0, 25.0], [0, 0, 1]], np.float32)])  # one K an image


@pytest.mark.parametrize(
    "shape,camera,skip",
    [((2, 48, 64, 3), None, False), ((2, 56, 70, 3), KS, False), ((2, 56, 70, 3), KS, True),
     ((1, 30, 100, 3), None, False)],  # last: aspect 3.3 -> padded top and bottom
    ids=["predicted-camera", "given-K", "given-K-skip-camera", "padded-aspect"],
)
def test_infer_matches_jax(models, shape, camera, skip):
    jm, tm = models
    rgb = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    ref = jm.infer(rgb, intrinsics=camera, skip_camera=skip)
    out = tm.infer(rgb, intrinsics=camera, skip_camera=skip)
    _check_infer(out, ref, shape)


def _check_infer(out, ref, shape):
    assert set(out) == set(ref) == {"depth", "points", "intrinsics"}
    b, h, w, _ = shape
    assert tuple(out["depth"].shape) == (b, h, w, 1) and tuple(out["points"].shape) == (b, h, w, 3)
    for key in out:
        assert out[key].dtype == torch.float32 and tuple(out[key].shape) == ref[key].shape, key
    d_ref = np.asarray(ref["depth"])
    assert (np.abs(out["depth"].numpy() - d_ref) / np.abs(d_ref)).max() < 1e-3
    np.testing.assert_allclose(out["intrinsics"].numpy(), np.asarray(ref["intrinsics"]), rtol=1e-4, atol=1e-4)
    p_ref = np.asarray(ref["points"])
    np.testing.assert_allclose(out["points"].numpy(), p_ref, rtol=1e-4, atol=1e-4 * np.abs(p_ref).max())


@pytest.mark.parametrize("given", ["none", "rays", "K-skip-camera"])
def test_encode_decode_matches_jax(models, given):
    """The eval forward on a normalised batch at the network shape: depth
    max relative error < 1e-3, points, rays, angles and intrinsics rtol
    1e-4 (atol 1e-4 scaled by the largest point)."""
    jm, tm = models
    img = np.random.default_rng(3).standard_normal((2, 56, 70, 3)).astype(np.float32)
    kwargs, jkwargs = {}, {}
    if given != "none":
        rays = np.array(j_generate_rays(jnp.asarray(KS), (56, 70))[0])
        kwargs["rays_gt"], jkwargs["rays_gt"] = torch.from_numpy(rays), jnp.asarray(rays)
    if given == "K-skip-camera":
        kwargs.update(K_gt=torch.from_numpy(KS), skip_camera=True)
        jkwargs.update(K_gt=jnp.asarray(KS), skip_camera=True)
    out = tm.encode_decode(torch.from_numpy(img), **kwargs)
    ref = jm.encode_decode(jm.params, jnp.asarray(img), **jkwargs)
    assert set(out) == set(ref)
    d_ref = np.asarray(ref["depth"])
    assert out["depth"].shape == d_ref.shape == (2, 56, 70, 1)
    assert (np.abs(out["depth"].detach().numpy() - d_ref) / np.abs(d_ref)).max() < 1e-3
    for key in ("intrinsics", "rays", "angles", "points"):
        want = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].detach().numpy(), want, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(want).max()),
                                   err_msg=key)
    if given == "K-skip-camera":
        np.testing.assert_array_equal(out["intrinsics"].numpy(), KS)


def test_infer_leaves_the_callers_K(models):
    _, tm = models
    rgb = np.random.default_rng(9).integers(0, 256, (2, 40, 60, 3), dtype=np.uint8)
    K_np, K_t = K.copy(), torch.from_numpy(K.copy())
    tm.infer(rgb, intrinsics=K_np)
    tm.infer(rgb, intrinsics=K_t, skip_camera=True)
    np.testing.assert_array_equal(K_np, K)
    np.testing.assert_array_equal(K_t.numpy(), K)


@pytest.mark.parametrize("value_range", ["unit", "normalized"])
def test_infer_input_heuristic_matches_jax(models, value_range):
    """Values in [0, 1] are normalised; values outside (already normalised
    images) pass as they are."""
    jm, tm = models
    rgb = np.random.default_rng(10).uniform(0, 1, (1, 56, 70, 3)).astype(np.float32)
    if value_range == "normalized":
        rgb = (rgb - 0.45) / 0.22
    _check_infer(tm.infer(rgb), jm.infer(rgb), rgb.shape)


def test_shape_helpers_match_jax():
    for image in ((231, 308), (462, 500), (30, 100), (480, 640), (1000, 300)):
        scaled, ratio = model_module._v1_shapes(image, (462, 616))
        assert (scaled, ratio) == j_model_module._v1_shapes(image, (462, 616))
        assert model_module._v1_paddings(scaled, (462, 616)) == j_model_module._v1_paddings(scaled, (462, 616))


# ---- entry points and weights ----------------------------------------------------


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_from_config_without_a_card_raises_naming_cpu(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        UniDepthV1.from_config(CFG)


def test_from_pretrained_reads_a_local_checkpoint(no_card, tmp_path):
    """The device is resolved first, then the reference-schema checkpoint
    (with the entries V1 drops) is loaded strictly."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        UniDepthV1.from_pretrained(tmp_path)
    src = UniDepthV1.from_config(CFG, device="cpu").init_params(seed=3)
    sd = dict(src.state_dict())
    sd["pixel_encoder.mask_token"] = torch.zeros(1, 64)
    sd["pixel_encoder.norm.weight"] = torch.ones(64)
    (tmp_path / "config.json").write_text(json.dumps(CFG))
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, tmp_path / "pytorch_model.bin")
    loaded = UniDepthV1.from_pretrained(tmp_path, device="cpu")
    for key, value in src.state_dict().items():
        assert torch.equal(loaded.state_dict()[key], value), key


def test_v1_rejects_int8_serving():
    """Blanket int8 is refused until ``calibrate_int8_stages`` has stored a
    stage mask (tests/test_torch_v1_int8.py calibrates)."""
    model = UniDepthV1.from_config(CFG, device="cpu")
    model.set_serving_precision("default")
    with pytest.raises(ValueError, match="calibrate_int8_stages"):
        model.set_serving_precision("int8")
    assert model.serving_precision == "default"


def test_round_trip_through_jax_layout_is_bit_exact():
    """reference schema -> convert_v1_state_dict (the JAX tree) ->
    from_jax_params: every key the port's model holds, bit for bit, none
    missing and none left over."""
    model = UniDepthV1.from_config(CFG, device="cpu")
    rng = np.random.default_rng(11)
    sd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32) for k, v in model.state_dict().items()}
    params = convert_v1_state_dict(sd, output_idx=(1, 2, 3, 4), backbone="dinov2", use_norm=False)
    back = from_jax_params(params, CFG)
    assert set(back) == set(model.state_dict())
    for key, value in back.items():
        assert torch.equal(value, torch.from_numpy(sd[key])), key
    model.load_state_dict(back)  # strict


def test_cvnxt_block_routes_ln_gelu_by_shape(monkeypatch):
    """LN -> pwconv1 -> GELU goes to K2 (``ln_dense``) exactly when C % 32
    == 0 and F % 128 == 0 and kernels are on, else to its plain version."""
    calls = []

    def spy(name, fn):
        return lambda x, w, *rest: calls.append((name, x.shape[-1], w.shape[0])) or fn(x, w, *rest)

    monkeypatch.setattr(layers_module, "ln_dense", spy("kernel", layers_module.ln_dense_plain))
    monkeypatch.setattr(layers_module, "ln_dense_plain", spy("plain", layers_module.ln_dense_plain))
    with torch.no_grad():
        for dim in (32, 48, 128, 16):  # F = 4C: 128 | 192 | 512 | 64
            CvnxtBlock(dim)(torch.zeros(1, 3, 4, dim))
        off = CvnxtBlock(128)
        off.use_kernels = False
        off(torch.zeros(1, 3, 4, 128))
    assert calls == [("kernel", 32, 128), ("plain", 48, 192), ("kernel", 128, 512), ("plain", 16, 64),
                     ("plain", 128, 512)]

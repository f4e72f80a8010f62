"""The port's UniDepthV2old against the JAX package's on shared weights (fp32,
CPU; JAX runs its Nystrom landmark attention, as the port does).

Pieces: ``resize(mode='nearest-exact')`` (V2old's depth resize back to the
input) bit for bit; ``ConvUpsampleShuffleResidual`` at rtol 1e-5; the
camera head's K, the global head's scale and shift, and the depth head's
pre-norm log-depth and confidence, each applied alone with its JAX
parameter subtree, at rtol 1e-4 / atol 1e-4 max|ref|, the depth head also
on a 12 x 12 grid (144 > 128 tokens: the landmark path, not its exact
fallback). The token-budget ``_shapes`` over a grid of sizes and every
resolution level. The whole tiny model (ViT C = 64, 4 blocks, 2 heads;
decoder hidden 32, depths (1, 1, 1)): fp32 ``infer()`` depth at rtol 5e-3,
the JAX package's own bound where the whole-map norm amplifies rounding
(tests/test_v2old_parity.py:57, docs/PARITY.md:149-155), K and points at
rtol 1e-4; ``encode_decode`` in float64 on both sides at max relative depth
error < 1e-3 (docs/PARITY.md:148). Int8: the encoder's codes and scales
equal JAX ``quantize_dense_tree`` bit for bit, and the int8 forward holds
JAX's on one batch. Key compatibility: the port's state_dict through
the JAX ``convert_v2old_state_dict`` gives JAX's forward; the module keys
and shapes equal the reference checkpoint's inventory. Then the entry
points: ``scripts_torch/eval.py`` on a V2old config and the ``UniDepth``
factory over its seven pairs.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.io.convert import convert_v2old_state_dict
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.models.unidepthv2.old import CameraHeadOld as JCameraHeadOld
from unidepth_tpu.models.unidepthv2.old import DepthHeadOld as JDepthHeadOld
from unidepth_tpu.models.unidepthv2.old import GlobalHeadOld as JGlobalHeadOld
from unidepth_tpu.models.unidepthv2.old import UniDepthV2old as JUniDepthV2old
from unidepth_tpu.nn.upsample import ConvUpsampleShuffleResidual as JConvUpsampleShuffleResidual
from unidepth_tpu.ops.quant import dynamic_quant as j_dynamic_quant
from unidepth_tpu.ops.quant import quantize_dense_tree
from unidepth_tpu.ops.resize import resize as j_resize
from unidepth_tpu_torch.hubconf import UniDepth
from unidepth_tpu_torch.io.convert import conv_upsample_shuffle_state_dict, from_jax_params
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old
from unidepth_tpu_torch.nn.upsample import ConvUpsampleShuffleResidual
from unidepth_tpu_torch.ops.quant import dynamic_quant
from unidepth_tpu_torch.ops.resize import resize

ROOT = Path(__file__).resolve().parents[1]
HIDDEN, DEPTHS, HEADS = 32, (1, 1, 1), 2
CFG = {
    "model": {
        "name": "UniDepthV2old", "num_heads": HEADS, "expansion": 4,
        "pixel_decoder": {"hidden_dim": HIDDEN, "depths": list(DEPTHS)},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2, "pos_embed_size": 8,
            "output_idx": [1, 2, 3, 4], "use_norm": True,
        },
    },
    "data": {"image_shape": [56, 70]},
}
VIT = dict(embed_dim=64, depth=4, num_heads=2, pos_embed_size=8, output_idx=(1, 2, 3, 4), use_norm=True)
BOUNDS = (12, 30)  # tokens: small networks shapes for the CPU


def _close(t, j, rtol=1e-4, atol_scale=1e-4):
    want = np.asarray(j)
    got = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * max(np.abs(want).max(), 1e-30))


def _noisy(params, seed):
    """JAX init plus seeded noise, so that zero-initialised biases, tokens
    and unit scales carry information through the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), params)


def _jax_model(dtype=jnp.float32):
    return JUniDepthV2old(JViTConfig(**VIT), hidden_dim=HIDDEN, decoder_depths=DEPTHS, num_heads=HEADS,
                          pixels_bounds=BOUNDS, dtype=dtype)


def jit_init(jm, seed, shape=(56, 70)):
    """``UniDepthV2old.init_params`` with both inits jitted."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    img = jnp.zeros((1, *shape, 3), jnp.float32)
    enc = jax.jit(jm.encoder.init)(k1, img)
    feats, cls_tokens = jax.eval_shape(jm.encoder.apply, enc, img)
    feats = [jnp.zeros(f.shape, jnp.float32) for f in feats]
    cls = [jnp.zeros(c.shape, jnp.float32) for c in cls_tokens]
    cam, glob = [cls[-3], cls[-2], cls[-1], cls[-2]], [cls[-2], cls[-1]]
    dec = jax.jit(jm.decoder.init, static_argnums=4)(k2, feats, cam, glob, shape)
    return {"encoder": enc["params"], "decoder": dec["params"]}


@pytest.fixture(scope="module")
def models():
    jm = _jax_model()
    jm.params = _noisy(jit_init(jm, 0), 7)
    tm = UniDepthV2old.from_config(CFG, device="cpu")
    tm.pixels_bounds = BOUNDS
    tm.load_state_dict(from_jax_params(jm.params, CFG))
    return jm, tm.eval()


# ---- the pieces ----------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((588, 784), (480, 640)), ((30, 40), (29, 41)),
                                     ((42, 56), (480, 640)), ((13, 17), (9, 5))])
def test_resize_nearest_exact_matches_jax(src, dst):
    """Bit for bit, at sizes where F.interpolate's float32 scale picks
    another neighbour than JAX's float64 one (30 -> 29 rows) too; bf16 in,
    bf16 out; the flags the mode does not take raise."""
    x = np.random.default_rng(sum(src)).standard_normal((2, *src, 3)).astype(np.float32)
    out = resize(torch.from_numpy(x), dst, mode="nearest-exact")
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_resize(jnp.asarray(x), dst, mode="nearest-exact")))
    nearest = resize(torch.from_numpy(x), dst, mode="nearest", channel_last=True)
    np.testing.assert_array_equal(nearest.numpy(), np.asarray(j_resize(jnp.asarray(x), dst, mode="nearest")))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(resize(xb, dst, mode="nearest-exact"), out.to(torch.bfloat16))
    with pytest.raises(ValueError, match="neither"):
        resize(torch.from_numpy(x), dst, mode="nearest-exact", align_corners=True)


def test_conv_upsample_shuffle_residual_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 7, 32)).astype(np.float32)
    up = JConvUpsampleShuffleResidual(32, expansion=4, kernel_size=7, num_layers=2, dtype=jnp.float32)
    params = _noisy(up.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    port = ConvUpsampleShuffleResidual(32)
    port.load_state_dict(conv_upsample_shuffle_state_dict(params))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    ref = up.apply({"params": params}, jnp.asarray(x))
    assert out.shape == ref.shape == (2, 4 * 42, 16)
    _close(out, ref, rtol=1e-5, atol_scale=1e-5)


def _tokens(rng, b, n, levels=4):
    return [rng.standard_normal((b, n, HIDDEN)).astype(np.float32) for _ in range(levels)]


def test_camera_head_matches_jax(models):
    jm, tm = models
    rng = np.random.default_rng(11)
    feats, cls = _tokens(rng, 2, 20), rng.standard_normal((2, 4, HIDDEN)).astype(np.float32)
    pos = rng.standard_normal((2, 80, HIDDEN)).astype(np.float32)
    ref = jax.jit(lambda p, f, c, q: JCameraHeadOld(HIDDEN).apply({"params": p}, f, c, q, (56, 70)))(
        jm.params["decoder"]["camera_layer"], feats, cls, pos)
    with torch.no_grad():
        out = tm.pixel_decoder.camera_layer([torch.from_numpy(f) for f in feats], torch.from_numpy(cls),
                                            torch.from_numpy(pos), (56, 70))
    _close(out, ref)


def test_global_head_matches_jax(models):
    jm, tm = models
    rng = np.random.default_rng(12)
    feats, cls = _tokens(rng, 2, 20), rng.standard_normal((2, 2, HIDDEN)).astype(np.float32)
    rays = rng.standard_normal((2, 56 * 70, 3)).astype(np.float32)
    ref = jax.jit(lambda p, f, c, r: JGlobalHeadOld(HIDDEN).apply({"params": p}, f, c, r, (4, 5), (56, 70)))(
        jm.params["decoder"]["global_layer"], feats, cls, rays)
    with torch.no_grad():
        out = tm.pixel_decoder.global_layer([torch.from_numpy(f) for f in feats], torch.from_numpy(cls),
                                            torch.from_numpy(rays), (4, 5), (56, 70))
    for o, r in zip(out, ref):
        assert o.shape == (2, 1, 1, 1)
        _close(o, r)


@pytest.mark.parametrize("grid", [(4, 5), (12, 12)], ids=["exact-attention", "landmarks"])
def test_depth_head_matches_jax(models, grid):
    """Pre-norm log-depth and confidence at the image shape; at 12 x 12 the
    level-0 Nystrom block has 144 tokens, more than its 128 landmarks."""
    jm, tm = models
    rng = np.random.default_rng(13)
    gh, gw = grid
    shape = (14 * gh, 14 * gw)
    feats = _tokens(rng, 2, gh * gw)
    rays = rng.standard_normal((2, shape[0] * shape[1], 3)).astype(np.float32)
    pos, le = (rng.standard_normal((2, 4 * gh * gw, HIDDEN)).astype(np.float32) for _ in range(2))
    head = JDepthHeadOld(HIDDEN, num_heads=HEADS, depths=DEPTHS)
    ref = jax.jit(lambda p, f, r, q, e: head.apply({"params": p}, f, r, q, e, grid, shape))(
        jm.params["decoder"]["depth_layer"], feats, rays, pos, le)
    with torch.no_grad():
        out = tm.pixel_decoder.depth_layer([torch.from_numpy(f) for f in feats], torch.from_numpy(rays),
                                           torch.from_numpy(pos), torch.from_numpy(le), grid, shape)
    assert out[0].shape == (2, *shape, 1)
    for o, r in zip(out, ref):
        _close(o, r)


def test_shapes_match_jax(models):
    jm, tm = models
    try:
        for level in (None, *range(11)):
            jm.resolution_level = tm.resolution_level = level
            for bounds in ((1400, 2400), BOUNDS):
                jm.pixels_bounds = tm.pixels_bounds = bounds
                for image in ((480, 640), (56, 70), (100, 150), (1000, 300), (375, 1242), (518, 518)):
                    assert tm._shapes(image) == jm._shapes(image), (level, bounds, image)
    finally:
        jm.resolution_level = tm.resolution_level = None
        jm.pixels_bounds = tm.pixels_bounds = BOUNDS
    assert tm._shapes((480, 640))[0] == (70, 98)  # 5 x 7 patches: the budget of 30 tokens at 4:3


# ---- the whole model -----------------------------------------------------------

K = np.array([[60.0, 0, 33.0], [0, 62.0, 27.0], [0, 0, 1]], np.float32)
KS = np.stack([K, np.array([[45.0, 0, 30.0], [0, 50.0, 25.0], [0, 0, 1]], np.float32)])


def _check_infer(out, ref, shape):
    assert set(out) == set(ref) == {"depth", "confidence", "points", "intrinsics"}
    for key in out:
        assert out[key].dtype == torch.float32 and tuple(out[key].shape) == ref[key].shape, key
    b, h, w, _ = shape
    assert tuple(out["depth"].shape) == (b, h, w, 1)
    np.testing.assert_allclose(out["depth"].numpy(), np.asarray(ref["depth"]), rtol=5e-3)
    np.testing.assert_allclose(out["confidence"].numpy(), np.asarray(ref["confidence"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["intrinsics"].numpy(), np.asarray(ref["intrinsics"]), rtol=1e-4, atol=1e-4)
    p_ref = np.asarray(ref["points"])
    np.testing.assert_allclose(out["points"].numpy(), p_ref, rtol=1e-4, atol=1e-4 * np.abs(p_ref).max())


@pytest.mark.parametrize("shape,camera", [((2, 48, 64, 3), None), ((2, 56, 70, 3), KS), ((1, 40, 100, 3), None)],
                         ids=["predicted-camera", "given-K", "wide"])
def test_infer_matches_jax(models, shape, camera):
    jm, tm = models
    rgb = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    K_in = None if camera is None else camera.copy()
    ref = jm.infer(rgb, intrinsics=camera)
    out = tm.infer(rgb, intrinsics=K_in)
    _check_infer(out, ref, shape)
    if camera is not None:
        np.testing.assert_array_equal(K_in, camera)  # the caller's K is not written


def test_encode_decode_float64_matches_jax(models):
    """Both sides in float64 on the same weights (the resizes and the
    log-depth before the whole-map norm stay float32 in both packages):
    depth holds < 1e-3 max relative error, K, confidence and points rtol
    1e-4, and the given rays pass through."""
    jm, tm = models
    img = np.random.default_rng(5).standard_normal((2, 56, 70, 3))
    rays = np.random.default_rng(6).standard_normal((2, 56 * 70, 3))
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    t64 = copy.deepcopy(tm).double()
    with torch.no_grad():
        out = t64.encode_decode(torch.from_numpy(img), rays_gt=torch.from_numpy(rays))
    with jax.enable_x64(True):
        j64 = _jax_model(jnp.float64)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jm.params)
        ref = jax.jit(lambda p, x, r: j64.encode_decode(p, x, rays_gt=r))(p64, jnp.asarray(img), jnp.asarray(rays))
        ref = {k: np.asarray(v) for k, v in ref.items()}
    assert set(out) == set(ref)
    rel = np.abs(out["depth"].numpy() - ref["depth"]) / np.abs(ref["depth"])
    assert rel.max() < 1e-3, rel.max()
    for key in ("K", "confidence", "points"):
        np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=1e-4, atol=1e-4 * np.abs(ref[key]).max(),
                                   err_msg=key)
    np.testing.assert_array_equal(out["rays"].numpy(), rays)


def test_int8_codes_and_forward_match_jax(models):
    """Blanket int8 is accepted (V2old needs no calibration, as in JAX); the
    encoder's weight codes, scales and biases, and the activation codes and
    scales of its first GEMM's input, equal JAX's bit for bit; the int8
    network forward (serving encoder, then decoder) on one normalised batch
    holds JAX's at median relative depth error <= 1e-3 (a median: one
    flipped code moves a sample's K ~0.3%). ``infer()`` runs in int8 and drifts from the port's default
    ``infer()`` within the JAX package's int8 bounds (mean < 0.05, p99 < 0.15,
    intrinsics < 0.1, tests/test_quant.py). The two packages' int8
    ``infer()`` are not compared: their resizes differ by ~1e-7, which
    flips an activation code, and on this random-weight model the
    whole-map norm turns one flip into ~1% of depth (measured: JAX's own
    jitted and eager int8 ``infer()`` differ by a 1.0e-2 median)."""
    jm, tm = models
    rgb = np.random.default_rng(9).integers(0, 256, (2, 56, 70, 3), dtype=np.uint8)
    x = np.random.default_rng(10).standard_normal((2, 70, 84, 3)).astype(np.float32)
    qp = quantize_dense_tree(jm.params["encoder"])
    base = tm.infer(rgb)
    try:
        for m in (jm, tm):
            m.set_serving_precision("int8")
        enc = tm._serving_encoder()
        for i, blk in enumerate(enc.blocks):
            for name, layer in (("qkv", blk.attn.qkv), ("proj", blk.attn.proj), ("fc1", blk.mlp.fc1),
                                ("fc2", blk.mlp.fc2)):
                ref = qp[f"stage_{i}"][name]
                np.testing.assert_array_equal(layer.weight.numpy().T, np.asarray(ref["kernel"][0]))
                np.testing.assert_array_equal(layer.scale.numpy(), np.asarray(ref["scale"][0]))
                np.testing.assert_array_equal(layer.bias.numpy(), np.asarray(ref["bias"][0]))

        def jax_forward(params, image):
            feats, cls = jm._serving_encoder().apply({"params": params["encoder"]}, image)
            return jm.decoder.apply({"params": params["decoder"]}, feats, [cls[-3], cls[-2], cls[-1], cls[-2]],
                                    [cls[-2], cls[-1]], image.shape[1:3])

        ref = jax.jit(jax_forward)(jm._serving_params(), jnp.asarray(x))
        seen = []
        hook = enc.blocks[0].attn.qkv.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
        with torch.no_grad():
            out = tm._forward(tm._serving_encoder(), torch.from_numpy(x))
        hook.remove()
        served = tm.infer(rgb)
    finally:
        for m in (jm, tm):
            m.set_serving_precision("default")
    qj, sj = j_dynamic_quant(jnp.asarray(seen[0].numpy()))  # the first GEMM's input, quantized by both
    qt, st = dynamic_quant(seen[0])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    rel = np.abs(out["depth"].numpy() - np.asarray(ref["depth"])) / np.abs(np.asarray(ref["depth"]))
    assert np.median(rel) <= 1e-3, (np.median(rel), rel.max())
    drift = ((served["depth"] - base["depth"]).abs() / base["depth"].abs()).flatten()
    k_drift = ((served["intrinsics"] - base["intrinsics"]).abs() / (base["intrinsics"].abs() + 1e-6)).max()
    assert drift.mean() < 0.05 and torch.quantile(drift, 0.99) < 0.15 and k_drift < 0.1


def test_state_dict_through_the_jax_converter(models):
    """Key compatibility, standing in for a released checkpoint: the port's
    state_dict (reference keys) -> numpy -> JAX ``convert_v2old_state_dict``
    -> JAX forward equals the port's forward."""
    jm, _ = models
    tm = UniDepthV2old.from_config(CFG, device="cpu").init_params(seed=4).eval()
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = convert_v2old_state_dict(sd, output_idx=(1, 2, 3, 4), use_norm=True)
    img = np.random.default_rng(8).standard_normal((2, 56, 70, 3)).astype(np.float32)
    ref = jax.jit(jm.encode_decode)(params, jnp.asarray(img))
    with torch.no_grad():
        out = tm.encode_decode(torch.from_numpy(img))
    _close(out["K"], ref["K"])
    np.testing.assert_allclose(out["depth"].numpy(), np.asarray(ref["depth"]), rtol=5e-3)


@pytest.mark.parametrize("name", ["config_v2old_vits14", "config_v2old_vitl14"])
def test_module_keys_match_the_reference_inventory(name):
    """Every key and shape of the reference checkpoint
    (tests/fixtures/reference_state_dict_keys.json) after
    ``select_checkpoint_keys`` is the port's, and nothing else."""
    inventory = json.loads((ROOT / "tests/fixtures/reference_state_dict_keys.json").read_text())[name]
    config = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    with torch.device("meta"):
        model = UniDepthV2old.from_config(config, device="meta")
    sd = {k: torch.empty(shape, device="meta") for k, shape in inventory.items()}
    kept = model.select_checkpoint_keys(sd)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in kept.items()} == want
    model.load_state_dict(kept)  # strict


# ---- entry points --------------------------------------------------------------


def test_eval_cli_builds_v2old(tmp_path, capsys):
    """scripts_torch/eval.py on a V2old config, on the CPU, Dummy data: the
    model class comes from the config, the metrics are finite."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("eval_cli", ROOT / "scripts_torch" / "eval.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    cfg = tmp_path / "tiny_v2old.json"
    cfg.write_text(json.dumps(CFG))
    results = cli.main(["--config-file", str(cfg), "--dummy-data", "--max-iters", "1", "--batch", "2",
                        "--device", "cpu"])
    assert "evaluating UniDepthV2old" in capsys.readouterr().out
    assert np.isfinite(list(results["Dummy"].values())).all()


def test_factory_builds_every_hubconf_pair():
    """``UniDepth(version, backbone)`` builds the class and the config of
    each of the seven pairs of the root hubconf.py (on the meta device,
    so that no ViT-L is allocated)."""
    import ast

    tree = ast.parse((ROOT / "hubconf.py").read_text())
    table = next(n.value for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "_CONFIGS")
    pairs = ast.literal_eval(table)
    assert len(pairs) == 7
    classes = {"v1": UniDepthV1, "v2": UniDepthV2, "v2old": UniDepthV2old}
    for (version, backbone), path in pairs.items():
        config = json.loads((ROOT / path).read_text())
        with torch.device("meta"):
            model = UniDepth(version, backbone, device="meta")
        assert type(model) is classes[version]
        enc = config["model"]["pixel_encoder"]
        if "output_idx" in enc:
            assert tuple(model.pixel_encoder.cfg.output_idx) == tuple(enc["output_idx"])
        assert next(model.parameters()).device.type == "meta"
    with pytest.raises(KeyError):
        UniDepth("v2old", "vitb14", device="meta")

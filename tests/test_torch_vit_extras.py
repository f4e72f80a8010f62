"""The rest of the port's DINOv2 encoder against the JAX package on shared
weights (fp32, CPU): every stacking mode with and without register tokens,
the SwiGLU MLP, its int8 codes, and reference-layout checkpoints holding
registers and SwiGLU weights. Features and cls tokens at rtol/atol 1e-4, as
tests/test_torch_vit.py holds the 'last' encoder; int8 weight codes, scales
and biases bit for bit. Weights: JAX init plus seeded numpy noise, carried
across through ``encoder_state_dict``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidepth_tpu.io.convert import convert_encoder
from unidepth_tpu.models.backbones.dinov2 import DinoViT as JDinoViT
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.ops.quant import quantize_dense_tree
from unidepth_tpu_torch.io.convert import encoder_state_dict, normalize_state_dict
from unidepth_tpu_torch.models.backbones import dinov2 as tdinov2
from unidepth_tpu_torch.models.backbones.dinov2 import DinoViT, ViTConfig
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.ops.quant import QuantLinear

DIM, DEPTH, HEADS, POS = 32, 4, 2, 8
H, W = 56, 70  # a 4 x 5 patch grid: the 8 x 8 pos-embed grid is resized
TOL = dict(rtol=1e-4, atol=1e-4)
STACKINGS = ("last", "max_cls", "max", "mean", "first", "softmax")


def _kw(reg=0, ffn="mlp"):
    return dict(embed_dim=DIM, depth=DEPTH, num_heads=HEADS, pos_embed_size=POS, output_idx=(2, 4), use_norm=True,
                num_register_tokens=reg, ffn_layer=ffn)


def _image():
    return np.random.default_rng(0).standard_normal((2, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """(registers, ffn) -> JAX parameters, each made once: the init plus
    noise (the registers' normal(1e-6) init would hide a slicing error)."""
    made = {}

    def get(reg, ffn):
        if (reg, ffn) not in made:
            init = jax.jit(JDinoViT(cfg=JViTConfig(**_kw(reg, ffn)), dtype=jnp.float32).init)
            tree = init(jax.random.PRNGKey(0), jnp.asarray(_image()))["params"]
            rng = np.random.default_rng(1)
            made[reg, ffn] = jax.tree_util.tree_map(
                lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), tree
            )
        return made[reg, ffn]

    return get


def _compare(params, stacking, reg, ffn, tenc=None):
    jenc = JDinoViT(cfg=JViTConfig(**_kw(reg, ffn)), stacking=stacking, dtype=jnp.float32)
    feats_j, cls_j = jenc.apply({"params": params}, jnp.asarray(_image()))
    if tenc is None:
        tenc = DinoViT(ViTConfig(**_kw(reg, ffn)), stacking=stacking)
        tenc.load_state_dict(encoder_state_dict(params))
    with torch.no_grad():
        feats_t, cls_t = tenc(torch.from_numpy(_image()))
    assert len(feats_t) == len(feats_j) == 2 and len(cls_t) == len(cls_j) == 2
    for ft, fj in zip(feats_t, feats_j):
        assert ft.shape == (2, H // 14, W // 14, DIM)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL)
    for ct, cj in zip(cls_t, cls_j):
        assert ct.shape == (2, 1, DIM)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)


@pytest.mark.parametrize("reg", [0, 4], ids=["r0", "r4"])
@pytest.mark.parametrize("stacking", STACKINGS)
def test_stacking_matches_jax(params, stacking, reg):
    """Each stacking mode, with and without 4 register tokens: the features
    skip the registers (``1 + R:``) on every path, 'max_cls' and 'last'
    included."""
    _compare(params(reg, "mlp"), stacking, reg, "mlp")


@pytest.mark.parametrize("reg", [0, 4], ids=["r0", "r4"])
def test_swiglu_matches_jax(params, reg):
    _compare(params(reg, "swiglu"), "last", reg, "swiglu")


def test_swiglu_block_runs_unfused(monkeypatch):
    """The JAX ``_use_fused`` rule split in two: a SwiGLU block that is not
    int8 takes K1 for its attention and, where it reads as a CUDA bf16
    block that needs no gradient, K2's gated body for LN2 -> w12 -> silu(a)
    * g, then w3 (here CPU tensors read as CUDA ones, and each route runs its
    plain version); fp32 and autograd keep the SwiGLU modules; an int8
    block (``DinoViT.quantize``) takes K4 and the modules. The gated route
    computes the modules' function, within bf16 rounding."""
    calls = []

    def recorded(name, plain):
        def fn(*args, **kwargs):
            calls.append(name)
            return plain(*args, **kwargs)
        return fn

    def gated(x, w, b, gamma, beta, eps, activation):
        assert activation == "swiglu" and w.shape == (256, 64)
        calls.append("K2g")
        return tdinov2.ln_dense_plain(x, w, b, gamma, beta, eps, activation)

    monkeypatch.setattr(tdinov2, "flash_attention_qkv", recorded("K1", tdinov2.flash_attention_qkv_plain))
    monkeypatch.setattr(tdinov2, "flash_attention_packed", recorded("K4", tdinov2.flash_attention_packed_plain))
    monkeypatch.setattr(tdinov2, "ln_dense", gated)
    torch.manual_seed(0)
    # C = 64 and w12 2 x 128 rows: within K2's Hopper body
    cfg = ViTConfig(embed_dim=64, depth=2, num_heads=2, mlp_ratio=3.0, pos_embed_size=4, output_idx=(1, 2),
                    ffn_layer="swiglu")
    enc = DinoViT(cfg)
    image = torch.randn(1, 28, 42, 3)

    def run(encoder, dtype, grad=False):
        calls.clear()
        with torch.set_grad_enabled(grad):
            feats, _ = encoder(image.to(dtype))
        return feats, list(calls)

    assert run(enc.quantize(True), torch.float32)[1] == ["K4"] * cfg.depth
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert run(enc, torch.float32)[1] == ["K1"] * cfg.depth
    assert run(enc, torch.float32, grad=True)[1] == ["K1"] * cfg.depth
    enc16 = enc.to(torch.bfloat16)
    assert run(enc16, torch.bfloat16, grad=True)[1] == ["K1"] * cfg.depth
    feats, seen = run(enc16, torch.bfloat16)
    assert seen == ["K1", "K2g"] * cfg.depth
    for blk in enc16.blocks:
        blk.use_kernels = False
    ref, seen = run(enc16, torch.bfloat16)
    assert seen == []
    for a, b in zip(feats, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=1.6e-2, atol=1.6e-2)


def test_swiglu_int8_codes_match_jax(params):
    """``DinoViT.quantize`` turns w12 and w3 (and qkv, proj) into
    QuantLinears whose codes, scales and biases are JAX
    ``quantize_dense_tree``'s bit for bit; the int8 encoder's features stay
    within 1e-2 relative RMS of JAX's int8 encoder (one flipped activation
    code moves a feature by a fraction of a quantum)."""
    tree = params(4, "swiglu")
    tenc = DinoViT(ViTConfig(**_kw(4, "swiglu")))
    tenc.load_state_dict(encoder_state_dict(tree))
    qenc = tenc.quantize(True)
    qp = quantize_dense_tree(tree)
    for i, blk in enumerate(qenc.blocks):
        si, j = divmod(i, DEPTH // 2)
        for name, layer in (("qkv", blk.attn.qkv), ("proj", blk.attn.proj), ("w12", blk.mlp.w12), ("w3", blk.mlp.w3)):
            ref = qp[f"stage_{si}"][name]
            assert isinstance(layer, QuantLinear), name
            np.testing.assert_array_equal(layer.weight.numpy().T, np.asarray(ref["kernel"][j]))
            np.testing.assert_array_equal(layer.scale.numpy(), np.asarray(ref["scale"][j]))
            np.testing.assert_array_equal(layer.bias.numpy(), np.asarray(ref["bias"][j]))
    jq = JDinoViT(cfg=JViTConfig(**_kw(4, "swiglu")), quant=True, dtype=jnp.float32)
    feats_j, _ = jq.apply({"params": qp}, jnp.asarray(_image()))
    with torch.no_grad():
        feats_t, _ = qenc(torch.from_numpy(_image()))
    for ft, fj in zip(feats_t, feats_j):
        fj = np.asarray(fj)
        assert np.linalg.norm(ft.numpy() - fj) <= 1e-2 * np.linalg.norm(fj)


def _reference_layout(tree, reg):
    """The port's state_dict of ``tree`` as a reference checkpoint holds
    it: under ``pixel_encoder.`` in FB's chunked block layout, with
    ``mask_token`` and, without registers, the dormant (1, 1, C)
    ``register_tokens``."""
    sd = {}
    for k, v in encoder_state_dict(tree).items():
        if k.startswith("blocks."):
            i = int(k.split(".")[1])
            k = f"blocks.{i // 2}.{i}." + k.split(".", 2)[2]
        sd["pixel_encoder." + k] = v.numpy()
    sd["pixel_encoder.mask_token"] = np.zeros((1, DIM), np.float32)
    if not reg:
        sd["pixel_encoder.register_tokens"] = np.full((1, 1, DIM), 0.5, np.float32)
    return sd


@pytest.mark.parametrize("reg,ffn", [(4, "swiglu"), (0, "swiglu"), (4, "mlp")], ids=["r4-swiglu", "r0-swiglu", "r4"])
def test_reference_layout_checkpoint_loads(params, reg, ffn):
    """A reference-layout encoder checkpoint with registers (1, R, C) and
    ``mlp.w12`` / ``mlp.w3`` loads through ``normalize_state_dict`` and
    ``select_checkpoint_keys`` (the dormant (1, 1, C) at R = 0 dropped),
    and the encoder then computes JAX's ``convert_encoder`` of the same
    checkpoint."""
    sd = _reference_layout(params(reg, ffn), reg)
    config = {"model": {"pixel_encoder": {"name": "dinov2_vits14"}}}
    model = UniDepthV2(ViTConfig(**_kw(reg, ffn)), hidden_dim=32, out_dim=8, decoder_depths=(1, 1, 1), num_heads=2)
    want = model.select_checkpoint_keys(
        normalize_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, config))
    missing, unexpected = model.load_state_dict(want, strict=False)
    assert unexpected == [] and not [k for k in missing if k.startswith("pixel_encoder.")]
    if reg:
        assert model.pixel_encoder.register_tokens.shape == (1, reg, DIM)
    enc = {k.removeprefix("pixel_encoder."): v for k, v in sd.items() if k.startswith("pixel_encoder.")}
    jparams = convert_encoder(enc, output_idx=(2, 4), num_register_tokens=reg, use_norm=True)
    _compare(jparams, "last", reg, ffn, tenc=model.pixel_encoder)


def test_from_pretrained_takes_registers_and_stacking(tmp_path):
    """``from_pretrained`` of a reference-layout checkpoint whose config asks
    for 4 registers and softmax stacking (the keys JAX's ``from_config``
    reads): the (1, 4, C) registers load and the encoder stacks by softmax."""
    import json

    reg = 4
    config = {"model": {"name": "UniDepthV2", "num_heads": 2,
                        "pixel_decoder": {"hidden_dim": 32, "out_dim": 8, "depths": [1, 1, 1]},
                        "pixel_encoder": {"name": "dinov2_vits14", "embed_dim": DIM, "depth": DEPTH,
                                          "num_heads": HEADS, "pos_embed_size": POS, "output_idx": [1, 2, 3, 4],
                                          "use_norm": True, "num_register_tokens": reg, "stacking_fn": "softmax"}}}
    src = UniDepthV2.from_config(config, device="cpu").init_params(seed=3)
    assert src.pixel_encoder.stacking == "softmax" and src.pixel_encoder.register_tokens.shape == (1, reg, DIM)
    sd = {("module." + k): v for k, v in src.state_dict().items()}
    sd["module.pixel_encoder.mask_token"] = torch.zeros(1, DIM)
    (tmp_path / "config.json").write_text(json.dumps(config))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    loaded = UniDepthV2.from_pretrained(tmp_path, device="cpu")
    for k, v in src.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)

"""UniDepthV2 on DINOv2 ViT-g/14 (SwiGLU blocks): the port against the
benchmark's plain reference (``benchmark/reference/v2_swiglu.py``) at a tiny
size on the CPU, the plain version of K2's gated body, the ``vitg14`` preset
at its published widths (on the ``meta`` device), ``from_config``'s names,
and, on a card, the gated K2 against its plain version.

This file imports no JAX: its card test runs with ``--noconftest`` as
``tests/test_torch_cuda_kernels.py`` does."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn

from benchmark.families import unidepth_v2_swiglu as family
from benchmark.harness import weights
from benchmark.reference.ops import Numerics
from unidepth_tpu_torch.models.backbones.dinov2 import VIT_PRESETS, DinoViT, _SwiGLU
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.ops.fused_block import ln_dense, ln_dense_plain

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "configs" / "config_v2_vitg14.json").read_text())


def _tiny(config: dict) -> dict:
    """The ViT-g config at embed 64, 4 SwiGLU blocks of 2 heads, outputs at
    every block, a 32-wide decoder, and a pixel budget that keeps a 28 x 42
    image at its own size."""
    c = copy.deepcopy(config)
    c["model"]["pixel_encoder"].update(embed_dim=64, depth=4, num_heads=2, pos_embed_size=4, output_idx=[1, 2, 3, 4])
    c["model"]["pixel_decoder"].update(hidden_dim=32, depths=[1, 1, 1], out_dim=8)
    c["model"]["num_heads"] = 2
    c["data"]["augmentations"]["shape_constraints"].update(pixels_min=1000, pixels_max=4000)
    return c


def test_v2_swiglu_matches_the_plain_reference():
    """The port's fp32 CPU path (SwiGLU modules, K1's plain attention) against
    the reference on the benchmark's seeded weights (layer scales 0.1 as the
    cell draws them) and one uint8 image. Both sides run the same float32
    operations in other orders and groupings (the reference's attention is
    an explicit softmax, the port's the plain attention of K1), so they
    differ by float32 rounding, carried through the exponentials of the
    depth and confidence heads: rtol 1e-4, atol 1e-5, as the benchmark's
    reference tests hold the ViT-L reference."""
    config = _tiny(CONFIG)
    model = family.build(config, "cpu", torch.float32)
    assert all(isinstance(b.mlp, _SwiGLU) for b in model.pixel_encoder.blocks)
    values = weights.draw(weights.spec(model, 0.1), 11, "cpu")
    weights.load(model, values)
    rgb = torch.randint(0, 256, (1, 28, 42, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(3))
    assert family.network_shape(config, (28, 42)) == (28, 42)
    with torch.no_grad():
        ref = family.infer_reference(Numerics(), values, config, rgb)
    out = family.serve(model, rgb)
    for key in family.CHECKED_OUTPUTS:
        assert out[key].shape == ref[key].shape, key
        torch.testing.assert_close(out[key].float(), ref[key], rtol=1e-4, atol=1e-5, msg=key)


def test_control_fails_the_cell_limits():
    """The cell's control, the reference in fp8 in the program's place,
    fails one of ``v2-vitg14.serve-b8-518``'s limits on each of three seeds
    at the tiny configuration (the benchmark's ``test_control_fails_the_cell``
    for this cell, whose tiny configurations do not list it)."""
    from benchmark.harness import check, registry

    cell = registry.cell(ROOT, "v2-vitg14.serve-b8-518")
    config = _tiny(cell["config_file"]["config"])
    model = family.build(config, "cpu", torch.float32)
    assumed = cell["config_file"]["assumed"]
    entries = weights.spec(model, assumed["layer_scale"], assumed.get("weight_scales"))
    for seed in (1, 2, 3):
        values = weights.draw(entries, seed, "cpu")
        rgb = torch.randint(0, 256, (2, 28, 42, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(seed))
        got = check.numbers(family, config, values, [(rgb, {})], torch.device("cpu"), fp8=True)
        assert any(got[name] > limit for name, limit in cell["limits"].items()), (seed, got, cell["limits"])


def _bench_test_module(name: str, file: str, conftest=None):
    """A module of ``benchmark/tests`` loaded under ``name``; ``conftest``
    stands in for the ``conftest`` it imports while it loads (this
    directory's own conftest holds other names)."""
    import importlib.util
    import sys

    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "tests" / file)
    module = importlib.util.module_from_spec(spec)
    saved = sys.modules.get("conftest")
    if conftest is not None:
        sys.modules["conftest"] = conftest
    try:
        spec.loader.exec_module(module)
    finally:
        if saved is not None:
            sys.modules["conftest"] = saved
        elif conftest is not None:
            del sys.modules["conftest"]
    return module


_BENCH_CONFTEST = _bench_test_module("bench_conftest", "conftest.py")
_BENCH_CONTROL = _bench_test_module("bench_control", "test_bench_control.py", _BENCH_CONFTEST)


@pytest.mark.parametrize("fault", [None, _BENCH_CONTROL._alter_one_answer, _BENCH_CONTROL._half_batch, "control"],
                         ids=["sound", "alter_one_answer", "half_batch", "control"])
def test_faults_fail_the_cell_run(tmp_path, fault):
    """The benchmark's ``test_faults_fail_the_run`` for this cell, whose
    tiny configurations do not list it: a whole run of the cell's family on
    the tiny configuration (B = 2 at 28 x 42), held to the real cell's
    limits, the chip check skipped. Sound it is correct; with a fault
    underneath (one image's depth x 1.5, or half the batch served twice),
    or the control served in the program's place, it is not."""
    from benchmark.harness import check, session

    _BENCH_CONFTEST.TINY = {"tiny-vitg.serve": ("v2-vitg14", _tiny, [[28, 42]])}
    root = _BENCH_CONFTEST.make_root(tmp_path)
    _BENCH_CONTROL._with_real_limits(root, "tiny-vitg.serve", "v2-vitg14.serve-b8-518")
    if fault == "control":
        fault = check.control(root, "tiny-vitg.serve", 9)
    result, lines = session.run(root, "tiny-vitg.serve", 9, 0.3, False, "cpu", time.perf_counter(), fault=fault)
    assert result["correct"] is (fault is None), lines


def test_the_family_refuses_another_encoder():
    """A program that builds another encoder for the configuration (the
    parent of the ViT-g preset built ViT-S sizes) is refused at build."""
    config = _tiny(CONFIG)
    config["model"]["pixel_encoder"]["ffn_layer"] = "mlp"
    with pytest.raises(ValueError, match="SwiGLU"):
        family.build(config, "cpu", torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ln_dense_plain_swiglu_is_the_swiglu_module(dtype):
    """``w3(ln_dense_plain(x, w12, ..., 'swiglu'))`` is ``_SwiGLU(LayerNorm(x))``:
    the same float operations (fp32 LN, product, bias, silu and gate) in the
    same order, so equal to a few ulps."""
    torch.manual_seed(0)
    norm = nn.LayerNorm(64, eps=1e-6).to(dtype)
    mlp = _SwiGLU(64, 192).to(dtype)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1)
        norm.bias.normal_(0.0, 0.1)
        x = torch.randn(2, 5, 64, dtype=dtype) * 2 + 0.5
        got = mlp.w3(ln_dense_plain(x, mlp.w12.weight, mlp.w12.bias, norm.weight, norm.bias, norm.eps, "swiglu"))
        want = mlp(norm(x))
    assert mlp.w12.out_features == 2 * 128
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert ln_dense(x, mlp.w12.weight, mlp.w12.bias, norm.weight, norm.bias, norm.eps, "swiglu").shape == (2, 5, 128)


def test_vitg14_preset_at_its_published_widths():
    """``from_config`` of the shipped ViT-g config builds DINOv2 ViT-g/14 on
    the ``meta`` device (no 1.1 B parameters allocated): 1536 wide, 40
    SwiGLU blocks of 24 heads, w12 8192 x 1536, w3 1536 x 4096, outputs at
    (10, 20, 30, 40), ~1.13 B encoder parameters."""
    assert VIT_PRESETS["vitg14"].ffn_layer == "swiglu"
    with torch.device("meta"):
        model = UniDepthV2.from_config(CONFIG, device="meta")
    enc = model.pixel_encoder
    cfg = enc.cfg
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.output_idx) == (1536, 40, 24, (10, 20, 30, 40))
    assert len(enc.blocks) == 40 and {b.num_heads for b in enc.blocks} == {24}
    for b in enc.blocks:
        assert isinstance(b.mlp, _SwiGLU)
        assert tuple(b.mlp.w12.weight.shape) == (8192, 1536) and tuple(b.mlp.w3.weight.shape) == (1536, 4096)
    n = sum(p.numel() for p in enc.parameters())
    assert 1.12e9 < n < 1.15e9, n
    assert all(p.is_meta for p in model.parameters())


def test_from_config_refuses_an_unknown_encoder_without_sizes():
    """An encoder name no preset knows raises unless its config gives
    ``embed_dim``, ``depth`` and ``num_heads`` (it used to build ViT-S/14
    sizes); with them it builds what they say."""
    config = copy.deepcopy(_tiny(CONFIG))
    pe = config["model"]["pixel_encoder"]
    pe["name"] = "dinov2_vitx14"
    for key in ("embed_dim", "depth", "num_heads"):
        del pe[key]
    with pytest.raises(ValueError, match="names no preset"):
        UniDepthV2.from_config(config, device="meta")
    pe.update(embed_dim=48, depth=2, num_heads=3, ffn_layer="swiglu", mlp_ratio=2.0)
    with torch.device("meta"):
        model = UniDepthV2.from_config(config, device="meta")
    cfg = model.pixel_encoder.cfg
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.ffn_layer, cfg.mlp_ratio) == (48, 2, 3, "swiglu", 2.0)


class _RecordingLibrary:
    """The kernel library's stand-in: records each entry's name and
    arguments, reports success and writes nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


def test_gated_route_launches_in_its_span(monkeypatch):
    """A bf16 SwiGLU encoder read as on the card (CPU tensors read as CUDA
    ones; the library a recorder): each block's MLP launches the row
    statistics and ``ud_ln_swiglu_hopper_fwd`` at (M, C, 2H), once, in the
    host span ``unidepth.kernel.K2g`` under the encoder, and counts on
    ``ln_dense.gated_launches`` alone."""
    from unidepth_tpu_torch.models.backbones.dinov2 import ViTConfig
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.ops import fused_block as fb
    from unidepth_tpu_torch.utils import tracing

    lib = _RecordingLibrary()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    monkeypatch.setattr(fb, "ln_dense_plain", fb._ln_dense_kernel)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    cfg = ViTConfig(embed_dim=64, depth=3, num_heads=2, mlp_ratio=3.0, pos_embed_size=4, output_idx=(1, 2, 3),
                    ffn_layer="swiglu")
    enc = DinoViT(cfg).to(torch.bfloat16)
    before = fb.ln_dense.launches, fb.ln_dense.gated_launches
    tracing.enable()
    try:
        with torch.no_grad(), tracing.span("unidepth.infer.encoder"):
            enc(torch.randn(2, 28, 42, 3, dtype=torch.bfloat16))
        spans = tracing.collect()["spans"]
    finally:
        tracing.disable()
    assert (fb.ln_dense.launches, fb.ln_dense.gated_launches) == (before[0], before[1] + cfg.depth)
    m = 2 * (1 + 2 * 3)
    gemms = [args for name, args in lib.calls if name == "ud_ln_swiglu_hopper_fwd"]
    assert [name for name, _ in lib.calls] == ["ud_ln_row_stats", "ud_ln_swiglu_hopper_fwd"] * cfg.depth
    assert all(args[7:11] == (m, 64, 256, 1) for args in gemms)  # M, C, 2H, bf16 parameters
    by_id = {s["id"]: s for s in spans}
    gated = [s for s in spans if s["name"] == "unidepth.kernel.K2g"]
    assert len(gated) == cfg.depth and not [s for s in spans if s["name"] == "unidepth.kernel.K2"]
    assert {by_id[s["parent"]]["name"] for s in gated} == {"unidepth.infer.encoder"}


@pytest.mark.parametrize("dtype,c,f", [(torch.float32, 64, 256), (torch.bfloat16, 96, 256), (torch.bfloat16, 64, 384)],
                         ids=["fp32", "c-off-grid", "f-off-grid"])
def test_gated_route_refuses_what_its_body_cannot_take(monkeypatch, dtype, c, f):
    """The gated body is bf16 Hopper only (C % 64 == 0, C <= 2048, 2H %
    256 == 0): anything else raises before a launch, and nothing falls back."""
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.ops import fused_block as fb

    lib = _RecordingLibrary()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    x, w = torch.zeros(4, c, dtype=dtype), torch.zeros(f, c, dtype=dtype)
    b, g = torch.zeros(f, dtype=dtype), torch.zeros(c, dtype=dtype)
    with pytest.raises(ValueError, match="swiglu"):
        fb._ln_dense_kernel(x, w, b, g, g, 1e-6, "swiglu")
    assert lib.calls == []


def test_ptxas_reports_match_the_kernel_not_its_source_file(monkeypatch, tmp_path):
    """Every kernel of ``ln_dense_wgmma.cu`` carries the file's name in its
    anonymous namespace; ``ptxas_reports`` picks a kernel by its own
    (length-prefixed) identifier, so the GELU K2's report is never the gated
    body's (the build lists the gated body first)."""
    from unidepth_tpu_torch.ops import _cuda

    ns = "_ZN50_GLOBAL__N__65f8fe83_17_ln_dense_wgmma_cu_ac8a59b0"
    entries = [f"{ns}15ln_swiglu_wgmmaE14CUtensorMap_stS0_S0_PK6float2PKvS5_S5_iiii",
               f"{ns}14ln_dense_wgmmaE14CUtensorMap_stS0_S0_PK6float2PKvS5_S5_iiiii",
               f"{ns}12ln_row_statsEPK13__nv_bfloat16P6float2iif"]
    lines = []
    for i, e in enumerate(entries):
        lines += [f"ptxas info    : Compiling entry function '{e}' for 'sm_90a'",
                  f"ptxas info    : Used {100 + i} registers, used 16 barriers"]
    monkeypatch.setattr(_cuda, "BUILD_ROOT", tmp_path)
    (tmp_path / _cuda._build_key()).mkdir()
    (tmp_path / _cuda._build_key() / "nvcc.log").write_text("\n".join(lines))
    for i, kernel in enumerate(("ln_swiglu_wgmma", "ln_dense_wgmma", "ln_row_stats")):
        (report,) = _cuda.ptxas_reports(kernel)
        assert entries[i] in report[0] and report[1].endswith(f"Used {100 + i} registers, used 16 barriers")
    assert _cuda.ptxas_reports("wgmma_cu") == []


# --- on the card ------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,f", [(8 * 1370, 1536, 8192), (1000, 1024, 512)], ids=["vitg14-b8-518", "ragged-m"])
def test_gated_k2_matches_plain(dev, m, c, f):
    """K2's gated body against its plain version on the same bf16 inputs, at
    ViT-g/14's serving shape and at an M that is no multiple of the 128-row
    tile. Both round the normalised activation to bf16 before the product
    and the result to bf16; the plain version also rounds the product, so
    they differ by about an ulp of bf16: elementwise rtol 1.6e-2 and atol
    1e-2, the K2 tests' gates. Against the plain version in fp32 (a gated
    product of two rounded halves is no elementwise match near the gate's
    zeros) the relative RMS stays within the K2 tests' 5e-3."""
    rng = np.random.default_rng(m + c)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, torch.bfloat16)

    x = t(rng.standard_normal((m, c)) * 2 + 0.5)
    w = t(rng.standard_normal((f, c)) / np.sqrt(c))
    b = t(rng.standard_normal(f) * 0.1)
    g = t(1 + 0.1 * rng.standard_normal(c))
    bt = t(0.1 * rng.standard_normal(c))
    before = ln_dense.launches, ln_dense.gated_launches
    out = ln_dense(x, w, b, g, bt, 1e-6, "swiglu")
    torch.cuda.synchronize()
    assert (ln_dense.launches, ln_dense.gated_launches) == (before[0], before[1] + 1)
    plain = ln_dense_plain(x, w, b, g, bt, 1e-6, "swiglu")
    assert out.shape == plain.shape == (m, f // 2) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), plain.float(), rtol=1.6e-2, atol=1e-2)
    ref = ln_dense_plain(x.float(), w.float(), b.float(), g.float(), bt.float(), 1e-6, "swiglu")
    assert ((out.float() - ref).norm() / ref.norm()).item() <= 5e-3

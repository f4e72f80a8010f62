"""``from_pretrained`` of the port against every checkpoint source and layout
the JAX loader takes (unidepth_tpu/io/hub.py, io/convert.py), short of the
Hub download and the orbax ``params/`` tree: a directory, a bare weights
file with ``config.json`` beside it, an explicit ``config``, the shipped
config chosen by the backbone the path names, DINOv2's chunked FSDP block
layout, and the FB and CLIP ConvNeXt layouts, on synthetic state dicts
written from small models (as tests/test_converter_layouts.py does for
JAX). Each load is strict and bit for bit. The ConvNeXt renames are also
held to the JAX ``normalize_convnext_state_dict``.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.io.convert import _flatten_chunked_blocks as j_flatten_chunked_blocks
from unidepth_tpu.io.convert import normalize_convnext_state_dict as j_normalize_convnext
from unidepth_tpu.io.hub import _default_config as j_default_config
from unidepth_tpu_torch.io.convert import flatten_chunked_blocks, normalize_convnext_state_dict
from unidepth_tpu_torch.io.hub import _default_config, load_checkpoint
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.models.unidepthv2.old import UniDepthV2old

ROOT = Path(__file__).resolve().parents[1]
VIT = {"name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2, "pos_embed_size": 8,
       "output_idx": [1, 2, 3, 4], "use_norm": True}
V2 = {"model": {"name": "UniDepthV2", "num_heads": 2, "expansion": 4,
                "pixel_decoder": {"hidden_dim": 32, "out_dim": 16, "depths": [1, 1, 1]}, "pixel_encoder": VIT}}
V2OLD = {"model": {"name": "UniDepthV2old", "num_heads": 2, "expansion": 4,
                   "pixel_decoder": {"hidden_dim": 32, "depths": [1, 0, 0]}, "pixel_encoder": VIT}}
CONVNEXT = {"model": {"name": "UniDepthV1", "num_heads": 4, "expansion": 4,
                      "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
                      "pixel_encoder": {"name": "convnextv2_large", "depths": [1, 1, 2, 1],
                                        "dims": [32, 64, 128, 256]}},
            "data": {"image_shape": [64, 96]}}
CLASSES = {"UniDepthV2": UniDepthV2, "UniDepthV2old": UniDepthV2old, "UniDepthV1": UniDepthV1}


def _source(config, seed=3):
    return CLASSES[config["model"]["name"]].from_config(config, device="cpu").init_params(seed=seed)


def _assert_loaded(model, src):
    want = src.state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in got.items():
        assert torch.equal(value, want[key]), key


def _to_chunked(sd, chunk=2):
    """``pixel_encoder.blocks.{i}.*`` -> ``pixel_encoder.blocks.{i // chunk}.{i}.*``."""
    return {re.sub(r"^pixel_encoder\.blocks\.(\d+)\.",
                   lambda m: f"pixel_encoder.blocks.{int(m.group(1)) // chunk}.{m.group(1)}.", k): v
            for k, v in sd.items()}


def _to_fb(sd):
    """The port's timm ConvNeXt keys -> FB's (downsample_layers, stages.{s}.{j},
    dwconv, pwconv, grn.gamma/beta of shape (1, 1, 1, C)), plus FB's final
    norm and head."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("pixel_encoder."):
            out[k] = v
            continue
        k = k.replace("pixel_encoder.stem.", "pixel_encoder.downsample_layers.0.")
        k = re.sub(r"stages\.(\d+)\.downsample\.", r"downsample_layers.\1.", k)
        k = re.sub(r"stages\.(\d+)\.blocks\.(\d+)\.", r"stages.\1.\2.", k)
        k = k.replace(".conv_dw.", ".dwconv.").replace(".mlp.fc1.", ".pwconv1.").replace(".mlp.fc2.", ".pwconv2.")
        if ".mlp.grn." in k:
            k = k.replace(".mlp.grn.weight", ".grn.gamma").replace(".mlp.grn.bias", ".grn.beta")
            v = v.reshape(1, 1, 1, -1)
        out[k] = v
    c = CONVNEXT["model"]["pixel_encoder"]["dims"][-1]
    out.update({"pixel_encoder.norm.weight": torch.ones(c), "pixel_encoder.norm.bias": torch.zeros(c),
                "pixel_encoder.head.weight": torch.zeros(10, c), "pixel_encoder.head.bias": torch.zeros(10)})
    return out


def _to_clip(sd):
    """The timm keys under open_clip's ``visual.trunk.``, beside a projection
    head the loader drops."""
    out = {k.replace("pixel_encoder.", "pixel_encoder.visual.trunk.", 1): v for k, v in sd.items()}
    out["pixel_encoder.visual.head.proj.weight"] = torch.zeros(8, 256)
    return out


@pytest.mark.parametrize("config", [V2, V2OLD], ids=["v2", "v2old"])
@pytest.mark.parametrize("source", ["directory", "bare-file", "explicit-config", "safetensors"])
def test_from_pretrained_sources(tmp_path, config, source):
    """Directory (config.json + pytorch_model.bin), a bare ``.bin`` named
    anything with config.json beside it, a bare file with no config.json
    and ``config=`` given, and ``model.safetensors``; the reference's
    ``{"model": ...}`` wrapper and ``module.`` prefixes on the way."""
    src = _source(config)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    sd["module.pixel_encoder.mask_token"] = torch.zeros(1, 64)  # dropped by select_checkpoint_keys
    cls = CLASSES[config["model"]["name"]]
    if source == "safetensors":
        from safetensors.torch import save_file

        save_file({k: v.contiguous() for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
        (tmp_path / "config.json").write_text(json.dumps(config))
        model = cls.from_pretrained(tmp_path, device="cpu")
    else:
        weights = tmp_path / ("pytorch_model.bin" if source == "directory" else "last_checkpoint.pt")
        torch.save({"model": sd}, weights)
        if source != "explicit-config":
            (tmp_path / "config.json").write_text(json.dumps(config))
        kwargs = {"config": config} if source == "explicit-config" else {}
        model = cls.from_pretrained(tmp_path if source == "directory" else weights, device="cpu", **kwargs)
    _assert_loaded(model, src)


def test_explicit_config_overrides_config_json(tmp_path):
    src = _source(V2OLD)
    torch.save(src.state_dict(), tmp_path / "model.bin")
    (tmp_path / "config.json").write_text(json.dumps(V2))  # the wrong family
    _, sd = load_checkpoint(tmp_path, config=V2OLD)
    model = UniDepthV2old.from_pretrained(tmp_path, device="cpu", config=V2OLD)
    _assert_loaded(model, src)
    assert set(sd) == set(src.state_dict())


@pytest.mark.parametrize("version,name", [("2", "unidepth-v2-vits14"), ("2", "ckpt/unidepth-v2-vitb14"),
                                          ("2old", "unidepth-v2old-vitl14"), ("1", "unidepth-v1-vitl14")])
def test_default_config_by_backbone_name(tmp_path, version, name):
    """No config.json and none given: the shipped config of the version for
    the backbone the path names, as the JAX loader picks it."""
    path = tmp_path / f"{name}.bin"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"pixel_encoder.cls_token": torch.zeros(1, 1, 8)}, path)
    config, sd = load_checkpoint(path, version=version)
    backbone = re.search(r"vit[slb]14", name).group(0)
    assert config == json.loads((ROOT / "configs" / f"config_v{version}_{backbone}.json").read_text())
    if version in ("1", "2"):  # the JAX loader's versions are ints
        assert config == j_default_config(int(version), name)
    assert list(sd) == ["pixel_encoder.cls_token"]
    with pytest.raises(FileNotFoundError, match="no config"):
        _default_config(version, "unidepth-cnvnxtl")


def test_sources_the_port_does_not_take(tmp_path):
    with pytest.raises(FileNotFoundError, match="Hub download"):
        load_checkpoint("lpiccinelli/unidepth-v2-vitl14")
    (tmp_path / "params").mkdir()
    (tmp_path / "config.json").write_text(json.dumps(V2))
    with pytest.raises(FileNotFoundError, match="orbax"):
        load_checkpoint(tmp_path)


@pytest.mark.parametrize("config", [V2, V2OLD], ids=["v2", "v2old"])
def test_chunked_dinov2_blocks_load_flat(tmp_path, config):
    src = _source(config)
    chunked = _to_chunked(src.state_dict())
    assert "pixel_encoder.blocks.1.3.norm1.weight" in chunked
    (tmp_path / "config.json").write_text(json.dumps(config))
    torch.save(chunked, tmp_path / "pytorch_model.bin")
    _assert_loaded(CLASSES[config["model"]["name"]].from_pretrained(tmp_path, device="cpu"), src)
    enc = {k.removeprefix("pixel_encoder."): v for k, v in chunked.items() if k.startswith("pixel_encoder.")}
    assert set(flatten_chunked_blocks(enc)) == set(j_flatten_chunked_blocks(enc))


@pytest.mark.parametrize("layout", ["timm", "fb", "clip"])
def test_convnext_layouts_load(tmp_path, layout):
    """A ConvNeXt-V2 (GRN) V1 model from the timm, FB and CLIP layouts."""
    src = _source(CONVNEXT)
    sd = dict(src.state_dict())
    sd = {"timm": sd, "fb": _to_fb(sd), "clip": _to_clip(sd)}[layout]
    (tmp_path / "config.json").write_text(json.dumps(CONVNEXT))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    _assert_loaded(UniDepthV1.from_pretrained(tmp_path, device="cpu"), src)


def test_convnext_renames_match_jax():
    """The port's renames are the JAX ones, but for GRN, which the port keeps
    as timm's ``mlp.grn`` (its module) and JAX folds to ``grn`` (its
    converter's names)."""
    src = _source(CONVNEXT)
    enc = {k.removeprefix("pixel_encoder."): v.numpy() for k, v in src.state_dict().items()
           if k.startswith("pixel_encoder.")}
    fb = {k.removeprefix("pixel_encoder."): v.numpy() for k, v in _to_fb(src.state_dict()).items()
          if k.startswith("pixel_encoder.")}
    for layout in (enc, fb):
        ours, theirs = normalize_convnext_state_dict(layout), j_normalize_convnext(layout)
        assert {k.replace(".mlp.grn.", ".grn.") for k in ours} == set(theirs)
        for k, v in ours.items():
            np.testing.assert_array_equal(np.asarray(v).reshape(-1), np.asarray(theirs[k.replace(".mlp.grn.", ".grn.")]).reshape(-1))

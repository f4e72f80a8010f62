"""Carry weights from the JAX package to the port (inverse of
unidepth_tpu/io/convert.py ``convert_v2_state_dict``).

``from_jax_params`` turns the JAX ``UniDepthV2`` parameter tree, as numpy
arrays, into a state_dict with the reference checkpoint keys that
``unidepth_tpu_torch``'s ``UniDepthV2`` holds: it un-stacks the scanned
``stage_{si}`` encoder blocks, transposes Dense kernels back to (out, in),
turns ``patch_kernel`` (p*p*3, C) back into the conv (C, 3, p, p), turns
HWIO conv and (in, k, k, out) ConvTranspose kernels back into torch's
layouts, and reshapes ``level_embeds`` and the ResidualConvUnit gammas.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["decoder_state_dict", "encoder_state_dict", "from_jax_params"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _ln(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out: dict, prefix: str, p: Mapping) -> None:
    """flax Conv under a ``conv`` scope: HWIO kernel -> (O, I, kh, kw)."""
    out[f"{prefix}.weight"] = _t(np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = _t(p["conv"]["bias"])


def _mlp(out: dict, prefix: str, p: Mapping) -> None:
    _ln(out, f"{prefix}.norm", p["norm"])
    _dense(out, f"{prefix}.proj1", p["proj1"])
    _dense(out, f"{prefix}.proj2", p["proj2"])


def _attention_block(out: dict, prefix: str, p: Mapping) -> None:
    _ln(out, f"{prefix}.norm_attnx", p["norm_attnx"])
    _ln(out, f"{prefix}.norm_attnctx", p["norm_attnctx"])
    for name in ("kv", "q", "out"):
        _dense(out, f"{prefix}.{name}", p[name])
    _mlp(out, f"{prefix}.mlp", p["mlp"])
    for name in ("ls1", "ls2"):
        if name in p:
            out[f"{prefix}.{name}.gamma"] = _t(p[name]["gamma"])


def encoder_state_dict(p: Mapping, pre: str = "") -> dict[str, torch.Tensor]:
    """JAX ``DinoViT`` parameters -> the port's ``DinoViT`` state_dict (keys
    prefixed with ``pre``)."""
    out: dict[str, torch.Tensor] = {}
    kernel = np.asarray(p["patch_kernel"])  # (p*p*3, C), rows in (kh, kw, cin) order
    c = kernel.shape[1]
    patch = int(round((kernel.shape[0] // 3) ** 0.5))
    out[f"{pre}patch_embed.proj.weight"] = _t(kernel.reshape(patch, patch, 3, c).transpose(3, 2, 0, 1))
    out[f"{pre}patch_embed.proj.bias"] = _t(p["patch_bias"])
    out[f"{pre}cls_token"] = _t(p["cls_token"])
    out[f"{pre}pos_embed"] = _t(p["pos_embed"])
    i = 0
    for si in range(len([k for k in p if k.startswith("stage_")])):
        stage = p[f"stage_{si}"]
        for j in range(np.asarray(stage["norm1"]["scale"]).shape[0]):
            blk = _index_tree(stage, j)
            bp = f"{pre}blocks.{i}"
            _ln(out, f"{bp}.norm1", blk["norm1"])
            _dense(out, f"{bp}.attn.qkv", blk["qkv"])
            _dense(out, f"{bp}.attn.proj", blk["proj"])
            _ln(out, f"{bp}.norm2", blk["norm2"])
            _dense(out, f"{bp}.mlp.fc1", blk["fc1"])
            _dense(out, f"{bp}.mlp.fc2", blk["fc2"])
            if "ls1_gamma" in blk:
                out[f"{bp}.ls1.gamma"] = _t(blk["ls1_gamma"])
                out[f"{bp}.ls2.gamma"] = _t(blk["ls2_gamma"])
            i += 1
    if "norm" in p:
        _ln(out, f"{pre}norm", p["norm"])
    return out


def _index_tree(tree: Mapping, j: int):
    return {k: _index_tree(v, j) if isinstance(v, Mapping) else np.asarray(v)[j] for k, v in tree.items()}


def decoder_state_dict(p: Mapping, num_levels: int, pre: str = "") -> dict[str, torch.Tensor]:
    """JAX V2 ``Decoder`` parameters -> the port's ``Decoder`` state_dict
    (keys prefixed with ``pre``)."""
    out: dict[str, torch.Tensor] = {}
    n_inputs = len([k for k in p if k.startswith("input_adapter_")])
    for i in range(n_inputs):
        _dense(out, f"{pre}input_adapter.input_adapters.{i}", p[f"input_adapter_{i}"])
        _dense(out, f"{pre}camera_token_adapter.input_adapters.{i}", p[f"camera_token_adapter_{i}"])
    le = np.asarray(p["level_embeds"])
    out[f"{pre}level_embeds"] = _t(le.reshape(1, 1, *le.shape))

    cam, cp = p["camera_layer"], f"{pre}camera_layer"
    out[f"{cp}.latents_pos"] = _t(cam["latents_pos"])
    _mlp(out, f"{cp}.project", cam["project"])
    _mlp(out, f"{cp}.out_pinhole", cam["out_pinhole"])
    _attention_block(out, f"{cp}.aggregate1", cam["aggregate1"])
    _attention_block(out, f"{cp}.aggregate2", cam["aggregate2"])

    d, dp = p["depth_layer"], f"{pre}depth_layer"
    _dense(out, f"{dp}.to_latents", d["to_latents"])
    for i in range(4):
        for name, blk in d[f"prompt_camera_{i}"].items():
            j = int(name.removeprefix("layers_"))
            _attention_block(out, f"{dp}.prompt_camera.{i}.layers.{j}", blk)
    for i in range(num_levels):
        pf = d[f"process_features_{i}"]
        out[f"{dp}.process_features.{i}.weight"] = _t(np.asarray(pf["kernel"]).transpose(0, 3, 1, 2))
        out[f"{dp}.process_features.{i}.bias"] = _t(pf["bias"])
        ups = d[f"ups_{i}"]
        _conv(out, f"{dp}.ups.{i}.up.0", ups["up_proj"])
        for name, unit in ups.items():
            if not name.startswith("convs_"):
                continue
            up = f"{dp}.ups.{i}.convs.{int(name.removeprefix('convs_'))}"
            _conv(out, f"{up}.conv1", unit["conv1"])
            _conv(out, f"{up}.conv2", unit["conv2"])
            if "gamma" in unit:
                gamma = np.asarray(unit["gamma"])
                out[f"{up}.gamma"] = _t(gamma.reshape(1, -1, 1, 1))
    last = num_levels - 1
    _ln(out, f"{dp}.depth_mlp.{last}.0", d["depth_norm"])
    _dense(out, f"{dp}.depth_mlp.{last}.1", d["depth_linear"])
    _ln(out, f"{dp}.confidence_mlp.0", d["conf_norm"])
    _dense(out, f"{dp}.confidence_mlp.1", d["conf_linear"])
    _conv(out, f"{dp}.to_depth_lr", d["to_depth_lr"])
    _conv(out, f"{dp}.to_confidence_lr", d["to_conf_lr"])
    _conv(out, f"{dp}.to_depth_hr.0", d["to_depth_hr1"])
    _conv(out, f"{dp}.to_depth_hr.2", d["to_depth_hr2"])
    _conv(out, f"{dp}.to_confidence_hr.0", d["to_conf_hr1"])
    _conv(out, f"{dp}.to_confidence_hr.2", d["to_conf_hr2"])
    return out


def from_jax_params(params: Mapping, config: dict) -> dict[str, torch.Tensor]:
    """JAX ``{'encoder', 'decoder'}`` parameter tree (arrays of any kind
    numpy can read) -> float32 state_dict with reference checkpoint keys.
    ``config``: the reference-schema config dict the JAX model was built
    from (it gives the decoder's number of levels)."""
    num_levels = len(config["model"]["pixel_decoder"].get("depths", (2, 2, 2)))
    return {
        **encoder_state_dict(params["encoder"], "pixel_encoder."),
        **decoder_state_dict(params["decoder"], num_levels, "pixel_decoder."),
    }

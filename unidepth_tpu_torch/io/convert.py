"""Carry weights from the JAX package to the port (inverse of
unidepth_tpu/io/convert.py ``convert_v2_state_dict``,
``convert_v1_state_dict`` with ``convert_v1_decoder`` and
``convert_convnext``, and ``convert_v2old_state_dict``), and bring the
reference checkpoint layouts to the port's keys.

``normalize_state_dict`` is the reference loader's remapping, done before
a model selects its keys (``io.hub.load_checkpoint``): the ``{"model":
...}`` wrapper and every ``module.`` go, DINOv2's FSDP chunked layout
``blocks.{chunk}.{i}.*`` becomes ``blocks.{i}.*``
(``flatten_chunked_blocks``; the JAX ``_flatten_chunked_blocks``) and the
FB and CLIP ConvNeXt layouts become the timm one the port's ``ConvNeXt``
holds (``normalize_convnext_state_dict``; the JAX function of that name,
which folds timm's ``mlp.grn`` the other way, into its converter's names).

``from_jax_params`` turns the JAX ``UniDepthV2``, ``UniDepthV1`` or
``UniDepthV2old`` parameter tree (DINOv2 or ConvNeXt encoder), as numpy
arrays, into a
state_dict with the reference checkpoint keys that the port's model holds:
it un-stacks the scanned ``stage_{si}`` encoder blocks, transposes Dense
kernels back to (out, in), turns ``patch_kernel`` (p*p*3, C) back into the
conv (C, 3, p, p), turns HWIO conv and (in, k, k, out) ConvTranspose
kernels back into torch's layouts, and reshapes V2's ``level_embeds`` and
ResidualConvUnit gammas.

``from_jax_camera`` carries a JAX camera or ``BatchCamera`` across (params
and type ids as numpy).

``from_jax_train_state`` carries a JAX ``TrainState`` across: the params,
the Adam ``mu`` and ``nu`` (param-shaped trees, so ``from_jax_params`` maps
them, as it maps gradients: the mapping is linear per leaf), the EMA shadow
and its count, and the step.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

__all__ = ["conv_upsample_shuffle_state_dict", "conv_upsample_state_dict", "convnext_state_dict", "decoder_state_dict",
           "encoder_state_dict", "flatten_chunked_blocks", "from_jax_camera", "from_jax_params", "from_jax_train_state",
           "normalize_convnext_state_dict", "normalize_state_dict", "v1_decoder_state_dict", "v2old_decoder_state_dict"]


def flatten_chunked_blocks(sd: Mapping) -> dict:
    """DINOv2 keys ``blocks.{chunk}.{i}.*`` (FB's FSDP training layout, whose
    inner index is the global block index) -> ``blocks.{i}.*``; a flat
    layout passes as it is."""
    return {re.sub(r"^blocks\.\d+\.(\d+)\.", r"blocks.\1.", k): v for k, v in sd.items()}


def normalize_convnext_state_dict(sd: Mapping) -> dict:
    """A ConvNeXt checkpoint in any of the three layouts in the wild -> the
    timm keys of the port's ``ConvNeXt``: timm (``stem.0``,
    ``stages.{s}.blocks.{j}.conv_dw``, GRN as ``mlp.grn``) passes; CLIP
    (open_clip) loses its ``visual.trunk.`` prefix and the keys outside it;
    FB (``downsample_layers.{s}``, ``stages.{s}.{j}.dwconv``, ``pwconv1/2``,
    ``grn.gamma/beta`` of shape (1, 1, 1, C)) is renamed and the GRN
    parameters flattened."""
    if any(k.startswith("visual.trunk.") for k in sd):
        sd = {k[len("visual.trunk."):]: v for k, v in sd.items() if k.startswith("visual.trunk.")}
    if "stem.0.weight" in sd or "norm_pre.weight" in sd:
        return {re.sub(r"(blocks\.\d+)\.grn\.", r"\1.mlp.grn.", k): v for k, v in sd.items()}
    out = {}
    for k, v in sd.items():
        k = k.replace("downsample_layers.0.", "stem.")
        k = re.sub(r"stages\.(\d+)\.(\d+)\.", r"stages.\1.blocks.\2.", k)
        k = re.sub(r"downsample_layers\.(\d+)\.(\d+)\.", r"stages.\1.downsample.\2.", k)
        k = k.replace(".dwconv.", ".conv_dw.").replace(".pwconv1.", ".mlp.fc1.").replace(".pwconv2.", ".mlp.fc2.")
        if ".grn." in k:
            k = k.replace(".grn.gamma", ".mlp.grn.weight").replace(".grn.beta", ".mlp.grn.bias")
            v = v.reshape(-1)
        out[k] = v
    return out


def normalize_state_dict(state_dict: Mapping, config: dict) -> dict:
    """A reference checkpoint's state_dict -> the port's keys: unwrap
    ``{"model": ...}``, drop ``module.`` anywhere in a key (the reference
    uses str.replace), then flatten DINOv2's chunked blocks or, for an
    encoder named ``convnext*`` in ``config``, normalise the ConvNeXt
    layout, both under ``pixel_encoder.``."""
    if "model" in state_dict and isinstance(state_dict["model"], Mapping):
        state_dict = state_dict["model"]
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    pre = "pixel_encoder."
    enc = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    convnext = "convnext" in config["model"]["pixel_encoder"]["name"]
    enc = normalize_convnext_state_dict(enc) if convnext else flatten_chunked_blocks(enc)
    return {**{k: v for k, v in sd.items() if not k.startswith(pre)}, **{pre + k: v for k, v in enc.items()}}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _ln(out: dict, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv_kernel(out: dict, prefix: str, p: Mapping) -> None:
    """flax Conv: HWIO kernel -> (O, I, kh, kw)."""
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out: dict, prefix: str, p: Mapping) -> None:
    """flax Conv under a ``conv`` scope (``nn.conv.Conv2d``)."""
    _conv_kernel(out, prefix, p["conv"])


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


def _attention_decoder_block(out: dict, prefix: str, p: Mapping) -> None:
    """JAX ``AttentionDecoderBlock`` parameters -> the port's keys (the
    block's names are the same on both sides)."""
    for part in ("ca", "sa"):
        _ln(out, f"{prefix}.norm_{part}", p[f"norm_{part}"])
        _ln(out, f"{prefix}.norm_ctx_{part}", p[f"norm_ctx_{part}"])
        for name in ("kv", "q", "out"):
            _dense(out, f"{prefix}.{name}_{part}", p[f"{name}_{part}"])
    _mlp(out, f"{prefix}.mlp", p["mlp"])
    for name in ("ls1", "ls2", "ls3"):
        if name in p:
            out[f"{prefix}.{name}.gamma"] = _t(p[name]["gamma"])


def encoder_state_dict(p: Mapping, pre: str = "") -> dict[str, torch.Tensor]:
    """JAX ``DinoViT`` parameters -> the port's ``DinoViT`` state_dict (keys
    prefixed with ``pre``): the register tokens where it has them, and a
    block's MLP (``fc1``, ``fc2``) or SwiGLU (``w12``, ``w3``)."""
    out: dict[str, torch.Tensor] = {}
    kernel = np.asarray(p["patch_kernel"])  # (p*p*3, C), rows in (kh, kw, cin) order
    c = kernel.shape[1]
    patch = int(round((kernel.shape[0] // 3) ** 0.5))
    out[f"{pre}patch_embed.proj.weight"] = _t(kernel.reshape(patch, patch, 3, c).transpose(3, 2, 0, 1))
    out[f"{pre}patch_embed.proj.bias"] = _t(p["patch_bias"])
    out[f"{pre}cls_token"] = _t(p["cls_token"])
    out[f"{pre}pos_embed"] = _t(p["pos_embed"])
    if "register_tokens" in p:
        out[f"{pre}register_tokens"] = _t(p["register_tokens"])
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
            for name in ("fc1", "fc2", "w12", "w3"):  # the MLP's or SwiGLU's
                if name in blk:
                    _dense(out, f"{bp}.mlp.{name}", blk[name])
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


def convnext_state_dict(p: Mapping, pre: str = "") -> dict[str, torch.Tensor]:
    """JAX ``ConvNeXt`` parameters -> the port's ``ConvNeXt`` state_dict
    (timm keys, prefixed with ``pre``)."""
    out: dict[str, torch.Tensor] = {}
    _conv_kernel(out, f"{pre}stem.0", p["stem_conv"])
    _ln(out, f"{pre}stem.1", p["stem_norm"])
    for s in range(len([k for k in p if k.startswith("stage_")])):
        sp = f"{pre}stages.{s}"
        if s > 0:
            _ln(out, f"{sp}.downsample.0", p[f"down_norm_{s}"])
            _conv_kernel(out, f"{sp}.downsample.1", p[f"down_conv_{s}"])
        stage = p[f"stage_{s}"]
        for j in range(np.asarray(stage["norm"]["scale"]).shape[0]):
            blk, bp = _index_tree(stage, j), f"{sp}.blocks.{j}"
            _conv(out, f"{bp}.conv_dw", blk["dwconv"])
            _ln(out, f"{bp}.norm", blk["norm"])
            _dense(out, f"{bp}.mlp.fc1", blk["pwconv1"])
            _dense(out, f"{bp}.mlp.fc2", blk["pwconv2"])
            if "gamma" in blk:
                out[f"{bp}.gamma"] = _t(blk["gamma"])
            if "grn_gamma" in blk:
                out[f"{bp}.mlp.grn.weight"] = _t(blk["grn_gamma"])
                out[f"{bp}.mlp.grn.bias"] = _t(blk["grn_beta"])
    return out


def _adapter(out: dict, prefix: str, p: Mapping) -> None:
    _ln(out, f"{prefix}.0", p["norm"])
    _dense(out, f"{prefix}.1", p["linear"])


def v1_decoder_state_dict(p: Mapping, pre: str = "") -> dict[str, torch.Tensor]:
    """JAX ``DecoderV1`` parameters -> the port's ``DecoderV1`` state_dict
    (keys prefixed with ``pre``)."""
    out: dict[str, torch.Tensor] = {}
    for i in range(len([k for k in p if k.startswith("input_adapter_")])):
        _adapter(out, f"{pre}input_adapter.input_adapters.{i}", p[f"input_adapter_{i}"])
        _adapter(out, f"{pre}token_adapter.input_adapters.{i}", p[f"token_adapter_{i}"])
    out[f"{pre}level_embeds"] = _t(p["level_embeds"])
    _dense(out, f"{pre}level_embed_layer.0", p["le_fc1"])
    _dense(out, f"{pre}level_embed_layer.2", p["le_fc2"])
    _ln(out, f"{pre}level_embed_layer.3", p["le_norm"])

    cam, cp = p["camera_layer"], f"{pre}camera_layer"
    out[f"{cp}.latents_pos"] = _t(cam["latents_pos"])
    _ln(out, f"{cp}.cls_project.0", cam["cls_norm"])
    _dense(out, f"{cp}.cls_project.1", cam["cls_fc1"])
    _dense(out, f"{cp}.cls_project.3", cam["cls_fc2"])
    _mlp(out, f"{cp}.in_features", cam["in_features"])
    _attention_block(out, f"{cp}.aggregate", cam["aggregate"])
    for name in (k for k in cam if k.startswith("layers_")):
        _attention_block(out, f"{cp}.layers.{int(name.removeprefix('layers_'))}", cam[name])
    _mlp(out, f"{cp}.out", cam["out"])

    d, dp = p["depth_layer"], f"{pre}depth_layer"
    for name in ("project_rays16", "project_rays8", "project_rays4", "to_latents"):
        _mlp(out, f"{dp}.{name}", d[name])
    _dense(out, f"{dp}.features_channel_cat", d["features_channel_cat"])
    _attention_block(out, f"{dp}.aggregate_16", d["aggregate_16"])
    _attention_block(out, f"{dp}.prompt_camera", d["prompt_camera"])
    for name in (k for k in d if k.startswith("layers_")):
        scale, j = name.removeprefix("layers_").split("_")
        _attention_block(out, f"{dp}.layers_{scale}.{j}", d[name])
    for scale in (8, 4, 2):
        out.update(conv_upsample_state_dict(d[f"up{scale}"], f"{dp}.up{scale}."))
        _conv(out, f"{dp}.out{scale}", d[f"out{scale}"])
    return out


def conv_upsample_state_dict(p: Mapping, pre: str = "") -> dict[str, torch.Tensor]:
    """JAX ``ConvUpsample`` parameters -> the port's ``ConvUpsample``
    state_dict (keys prefixed with ``pre``)."""
    out: dict[str, torch.Tensor] = {}
    for name in (k for k in p if k.startswith("convs_")):
        blk, bp = p[name], f"{pre}convs.{int(name.removeprefix('convs_'))}"
        _conv(out, f"{bp}.dwconv", blk["dwconv"])
        _ln(out, f"{bp}.norm", blk["norm"])
        _dense(out, f"{bp}.pwconv1", blk["pwconv1"])
        _dense(out, f"{bp}.pwconv2", blk["pwconv2"])
        out[f"{bp}.gamma"] = _t(blk["gamma"])
    _conv(out, f"{pre}up.0", p["up_conv1"])
    _conv(out, f"{pre}up.2", p["up_conv2"])
    return out


def conv_upsample_shuffle_state_dict(p: Mapping, pre: str = "") -> dict[str, torch.Tensor]:
    """JAX ``ConvUpsampleShuffleResidual`` parameters -> the port's
    state_dict (keys prefixed with ``pre``)."""
    out: dict[str, torch.Tensor] = {}
    for name in (k for k in p if k.startswith("convs_")):
        blk, bp = p[name], f"{pre}convs.{int(name.removeprefix('convs_'))}"
        _conv(out, f"{bp}.dwconv", blk["dwconv"])
        _ln(out, f"{bp}.norm", blk["norm"])
        _dense(out, f"{bp}.pwconv1", blk["pwconv1"])
        _dense(out, f"{bp}.pwconv2", blk["pwconv2"])
        out[f"{bp}.gamma"] = _t(blk["gamma"])
    _conv(out, f"{pre}up.1", p["up_dw"])
    _conv(out, f"{pre}up.3", p["up_pw"])
    _conv(out, f"{pre}residual.0", p["residual_proj"])
    return out


def v2old_decoder_state_dict(p: Mapping, pre: str = "") -> dict[str, torch.Tensor]:
    """JAX ``DecoderV2Old`` parameters -> the port's ``DecoderV2Old``
    state_dict (keys prefixed with ``pre``; the inverse of
    ``convert_v2old_decoder``)."""
    out: dict[str, torch.Tensor] = {}
    for group in ("input_adapter", "camera_token_adapter", "global_token_adapter"):
        for i in range(len([k for k in p if k.startswith(f"{group}_")])):
            _adapter(out, f"{pre}{group}.input_adapters.{i}", p[f"{group}_{i}"])
    out[f"{pre}level_embeds"] = _t(p["level_embeds"])
    _dense(out, f"{pre}level_embed_layer.0", p["le_fc1"])
    _dense(out, f"{pre}level_embed_layer.2", p["le_fc2"])
    _ln(out, f"{pre}level_embed_layer.3", p["le_norm"])

    cam, cp = p["camera_layer"], f"{pre}camera_layer"
    out[f"{cp}.latents_pos"] = _t(cam["latents_pos"])
    for name in ("project_cls", "in_features", "out"):
        _mlp(out, f"{cp}.{name}", cam[name])
    glob, gp = p["global_layer"], f"{pre}global_layer"
    _mlp(out, f"{gp}.project_cls", glob["project_cls"])
    _mlp(out, f"{gp}.out", glob["out"])
    _dense(out, f"{gp}.project_rays", glob["project_rays"])
    _dense(out, f"{gp}.in_features", glob["in_features"])
    for head, hp in ((cam, cp), (glob, gp)):
        for name in ("aggregate1", "aggregate2"):
            _attention_block(out, f"{hp}.{name}", head[name])

    d, dp = p["depth_layer"], f"{pre}depth_layer"
    _mlp(out, f"{dp}.to_latents", d["to_latents"])
    _dense(out, f"{dp}.features_channel_cat", d["features_channel_cat"])
    _attention_block(out, f"{dp}.aggregate_16", d["aggregate_16"])
    _attention_block(out, f"{dp}.prompt_camera", d["prompt_camera"])
    for i in range(len([k for k in d if k.startswith("rays_layers_")])):
        _dense(out, f"{dp}.rays_layers.{i}", d[f"rays_layers_{i}"])
        for name in (k for k in d if k.startswith(f"process_layers_{i}_")):
            _attention_block(out, f"{dp}.process_layers.{i}.{int(name.rsplit('_', 1)[1])}", d[name])
        out.update(conv_upsample_shuffle_state_dict(d[f"ups_{i}"], f"{dp}.ups.{i}."))
        _mlp(out, f"{dp}.depth_mlp.{i}", d[f"depth_mlp_{i}"])
        _mlp(out, f"{dp}.confidence_mlp.{i}", d[f"confidence_mlp_{i}"])
    _conv(out, f"{dp}.to_depth", d["to_depth"])
    _conv(out, f"{dp}.to_confidence", d["to_confidence"])
    return out


def from_jax_params(params: Mapping, config: dict) -> dict[str, torch.Tensor]:
    """JAX ``{'encoder', 'decoder'}`` parameter tree (arrays of any kind
    numpy can read) -> float32 state_dict with reference checkpoint keys.
    ``config``: the reference-schema config dict the JAX model was built
    from: ``model.name`` picks the V1, V2old or V2 decoder, an encoder name
    holding ``convnext`` the ConvNeXt encoder, and V2's decoder depths give
    its number of levels."""
    model = config["model"]
    if "convnext" in model["pixel_encoder"]["name"]:
        encoder = convnext_state_dict(params["encoder"], "pixel_encoder.")
    else:
        encoder = encoder_state_dict(params["encoder"], "pixel_encoder.")
    if model.get("name") == "UniDepthV1":
        return {**encoder, **v1_decoder_state_dict(params["decoder"], "pixel_decoder.")}
    if model.get("name") == "UniDepthV2old":
        return {**encoder, **v2old_decoder_state_dict(params["decoder"], "pixel_decoder.")}
    num_levels = len(model["pixel_decoder"].get("depths", (2, 2, 2)))
    return {**encoder, **decoder_state_dict(params["decoder"], num_levels, "pixel_decoder.")}


def _adam_state(tree):
    """The optax ``ScaleByAdamState`` (count, mu, nu) inside an optimizer
    state, found by its fields."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    for child in tree if isinstance(tree, (tuple, list)) else ():
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def from_jax_train_state(state, config: dict, names=None):
    """JAX ``TrainState`` (params, optax ``opt_state`` holding a
    ``ScaleByAdamState``, ``EMAState``, step) -> the port's ``TrainState``
    on the CPU. ``names``: the model's parameter names, in its order; the
    other keys (buffers, such as V2's ``level_embeds``) are left out."""
    from unidepth_tpu_torch.training.ema import EMAState
    from unidepth_tpu_torch.training.optim import AdamWState
    from unidepth_tpu_torch.training.step import TrainState

    def tree(t):
        sd = from_jax_params(t, config)
        return sd if names is None else {n: sd[n] for n in names}

    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("opt_state holds no Adam state (mu, nu)")
    return TrainState(
        params=tree(state.params),
        opt_state=AdamWState(count=int(np.asarray(adam.count)), mu=tree(adam.mu), nu=tree(adam.nu)),
        ema=EMAState(shadow=tree(state.ema.shadow), num_updates=int(np.asarray(state.ema.num_updates))),
        step=int(np.asarray(state.step)),
    )


def from_jax_camera(camera):
    """A JAX camera of ``unidepth_tpu.geometry.cameras`` -> the port's class
    of the same name on the CPU; a ``BatchCamera`` keeps its type ids (both
    packages order the types alike), a Newton model its step count."""
    from unidepth_tpu_torch.geometry import cameras

    params = torch.from_numpy(np.array(camera.params, dtype=np.float32))
    if type(camera).__name__ == "BatchCamera":
        return cameras.BatchCamera(params, torch.from_numpy(np.array(camera.type_ids, dtype=np.int64)))
    out = getattr(cameras, type(camera).__name__)(params)
    if hasattr(camera, "iters"):
        out.iters = camera.iters
    return out

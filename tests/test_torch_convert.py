"""Weights across the two packages, the port's import boundary, and its
refusal to run plain on a non-CPU tensor."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.io.convert import convert_v2_state_dict
from unidepth_tpu_torch.io.convert import from_jax_params
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.ops.flash_attention import flash_attention, flash_attention_qkv
from unidepth_tpu_torch.ops.fused_block import ln_dense

ROOT = Path(__file__).resolve().parents[1]
CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2,
        "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 2, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 128, "depth": 4, "num_heads": 2,
            "pos_embed_size": 8, "output_idx": [1, 2, 3, 4], "use_norm": True,
        },
    },
}


def _reference_state_dict(model, seed=0):
    """A random state_dict in the reference checkpoint schema for ``model``,
    including the entries the reference carries and the port drops."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    shapes["pixel_encoder.mask_token"] = (1, 128)
    shapes["pixel_encoder.register_tokens"] = (1, 1, 128)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def test_round_trip_through_jax_layout_is_bit_exact():
    """reference schema -> convert_v2_state_dict (JAX tree) -> from_jax_params
    reproduces every key the port's model holds, bit for bit."""
    model = UniDepthV2.from_config(CFG, device="cpu")
    sd = _reference_state_dict(model)
    params = convert_v2_state_dict(sd, output_idx=(1, 2, 3, 4), num_levels=3, use_norm=True)
    back = from_jax_params(params, CFG)
    assert set(back) == set(model.state_dict())
    for key, value in back.items():
        assert torch.equal(value, torch.from_numpy(sd[key])), key
    model.load_state_dict(back)  # strict


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_from_pretrained_local_checkpoint(tmp_path, fmt):
    model = UniDepthV2.from_config(CFG, device="cpu")
    sd = {k: torch.from_numpy(v) for k, v in _reference_state_dict(model, seed=1).items()}
    (tmp_path / "config.json").write_text(json.dumps(CFG))
    if fmt == "bin":  # a DDP prefix is stripped, as the reference loader does
        torch.save({f"module.{k}": v for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    else:
        from safetensors.torch import save_file

        save_file(sd, str(tmp_path / "model.safetensors"))
    loaded = UniDepthV2.from_pretrained(tmp_path, device="cpu")
    for key, value in loaded.state_dict().items():
        assert torch.equal(value, sd[key]), key


def test_init_params_is_seeded():
    a = UniDepthV2.from_config(CFG, device="cpu").init_params(seed=3).state_dict()
    b = UniDepthV2.from_config(CFG, device="cpu").init_params(seed=3).state_dict()
    c = UniDepthV2.from_config(CFG, device="cpu").init_params(seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pixel_encoder.pos_embed"], c["pixel_encoder.pos_embed"])


def test_import_leaves_jax_out():
    code = (
        "import sys, unidepth_tpu_torch.models.unidepthv2.model, unidepth_tpu_torch.io.convert, "
        "unidepth_tpu_torch.io.hub, unidepth_tpu_torch.ops._cuda, unidepth_tpu_torch.models.unidepthv2.old, "
        "unidepth_tpu_torch.hubconf; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'unidepth_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("kernel", ["flash_attention_qkv", "flash_attention", "ln_dense"])
def test_non_cpu_tensor_never_runs_plain(kernel):
    """A tensor off the CPU goes to the CUDA kernel or raises; here (a meta
    tensor) it raises, and no launch is counted."""
    meta = dict(device="meta")
    calls = {
        "flash_attention_qkv": (flash_attention_qkv, (torch.empty(1, 16, 384, **meta), 2, 0.125)),
        "flash_attention": (flash_attention, (*(torch.empty(2, 16, 64, **meta) for _ in range(3)), 0.125)),
        "ln_dense": (ln_dense, (torch.empty(4, 128, **meta), torch.empty(256, 128, **meta),
                                *(torch.empty(n, **meta) for n in (256, 128, 128)), 1e-6, "gelu")),
    }
    fn, args = calls[kernel]
    before = fn.launches
    with pytest.raises((ValueError, RuntimeError)):
        fn(*args)
    assert fn.launches == before

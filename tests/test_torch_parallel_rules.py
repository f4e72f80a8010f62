"""The port's parallel layer without processes: the sharding rules against
the JAX package's on the same parameters (the port's torch layout
translated to flax's), ``check_batch_divisibility`` and the fail-fast
``initialize_distributed`` on the cases of tests/test_fsdp.py, the tp
slicing of fused projections, the sharded evaluation batches, and the mesh
of one process."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_threads  # noqa: F401  (sets this process's torch thread count)

import unidepth_tpu.parallel.mesh as j_mesh
from unidepth_tpu_torch.datasets.dummy import Dummy
from unidepth_tpu_torch.datasets.loader import eval_batches
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.parallel import mesh as mesh_mod
from unidepth_tpu_torch.parallel.mesh import (
    FSDP_MIN_SIZE,
    check_batch_divisibility,
    fsdp_param_sharding,
    make_mesh,
    param_layouts,
    tp_join,
    tp_param_sharding,
    tp_slice,
)

ROOT = Path(__file__).resolve().parents[1]
FLAX_DIMS = {"linear": (1, 0), "conv": (2, 3, 1, 0), "conv_transpose": (2, 3, 0, 1)}


def _port_params(config: str):
    """(name -> shape, name -> layout kind) of the port's UniDepthV2, built
    on the meta device."""
    cfg = json.loads((ROOT / "configs" / config).read_text())
    with torch.device("meta"):
        model = UniDepthV2.from_config(cfg, device="meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}, param_layouts(model)


def _flax_tree(shapes: dict, layouts: dict):
    """The same parameters as the JAX rule sees them: nested by name, a
    weight in the flax kernel layout named ``kernel``, each leaf a shape."""
    tree, dims = {}, {}
    for name, shape in shapes.items():
        *path, leaf = name.split(".")
        d = FLAX_DIMS.get(layouts.get(name), tuple(range(len(shape))))
        if name in layouts:
            leaf = "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(shape[i] for i in d), np.float32)
        dims[name] = d
    return tree, dims


def _jax_splits(specs, shapes: dict, layouts: dict, dims: dict) -> dict:
    """The JAX specs per port name: {axis name: torch dim}."""
    out = {}
    for name in shapes:
        *path, leaf = name.split(".")
        node = specs
        for p in path:
            node = node[p]
        spec = node["kernel" if name in layouts else leaf].spec
        out[name] = {ax: dims[name][a] for a, ax in enumerate(spec) if ax is not None}
    return out


def _port_as_dict(splits) -> dict:
    return {n: {k: v for k, v in (("fsdp", s.fsdp), ("tp", s.tp)) if v is not None} for n, s in splits.items()}


@pytest.mark.parametrize("config", ["config_v2_vits14.json", "config_v2_vitl14.json"])
@pytest.mark.parametrize("floor", [FSDP_MIN_SIZE, 65536])
def test_fsdp_rule_matches_jax(config, floor, monkeypatch):
    """Every parameter of V2 (ViT-S/14 and ViT-L/14) takes the JAX rule's
    fsdp dim, translated from the flax layout, at the production size floor
    and at a lower one."""
    monkeypatch.setattr(j_mesh, "_FSDP_MIN_SIZE", floor)
    monkeypatch.setattr(mesh_mod, "FSDP_MIN_SIZE", floor)
    shapes, layouts = _port_params(config)
    tree, dims = _flax_tree(shapes, layouts)
    want = _jax_splits(j_mesh.fsdp_param_sharding(j_mesh.make_mesh(data=4, fsdp=2), tree), shapes, layouts, dims)
    got = _port_as_dict(fsdp_param_sharding({"fsdp": 2}, shapes, layouts))
    assert got == want
    assert any(want.values()) == (floor < FSDP_MIN_SIZE or config == "config_v2_vitl14.json")


@pytest.mark.parametrize("config", ["config_v2_vits14.json", "config_v2_vitl14.json"])
def test_tp_rule_matches_jax(config):
    """The tp x fsdp rule on a data 2 x fsdp 2 x tp 2 mesh: column modules
    on the torch weight's dim 0 and bias, row modules on dim 1, fsdp on the
    other dim above the floor, everything else the fsdp rule; the same as
    the JAX rule wherever the port splits (the patch embedding, a conv
    named like a row projection whose input channels tp does not divide,
    stays whole in both). The fused projections keep a rank's heads of
    each block."""
    shapes, layouts = _port_params(config)
    tree, dims = _flax_tree(shapes, layouts)
    want = _jax_splits(j_mesh.tp_param_sharding(j_mesh.make_mesh(data=2, fsdp=2, tp=2), tree), shapes, layouts, dims)
    splits = tp_param_sharding({"data": 2, "fsdp": 2, "tp": 2}, shapes, layouts=layouts)
    assert _port_as_dict(splits) == want
    blocks = {n.rsplit(".", 2)[-2]: s.blocks for n, s in splits.items() if s.tp is not None}
    assert blocks["qkv"] == 3 and blocks["kv"] == 2 and blocks["fc1"] == blocks["proj"] == 1
    assert splits["pixel_encoder.blocks.0.attn.qkv.weight"].tp == 0
    assert splits["pixel_encoder.blocks.0.attn.proj.weight"].tp == 1
    assert splits["pixel_encoder.blocks.0.attn.proj.bias"].tp is None
    whole = tp_param_sharding({"tp": 2}, shapes, layouts=layouts, whole={"pixel_encoder.blocks.0.attn"})
    assert whole["pixel_encoder.blocks.0.attn.qkv.weight"].tp is None
    assert whole["pixel_encoder.blocks.0.mlp.fc1.weight"].tp == 0


def test_tp_slice_takes_each_blocks_heads():
    """qkv's rows are [q | k | v], each (heads, D): a rank's slice is its
    heads of each, and tp_join gives back the whole."""
    heads, d, c = 4, 3, 5
    w = torch.arange(3 * heads * d * c, dtype=torch.float32).reshape(3 * heads * d, c)
    pieces = [tp_slice(w, 0, 3, 2, r) for r in range(2)]
    q, k, v = w.reshape(3, heads, d, c)
    assert torch.equal(pieces[1].reshape(3, 2, d, c), torch.stack([q[2:], k[2:], v[2:]]))
    assert torch.equal(tp_join(pieces, 0, 3), w)
    x = torch.randn(7, 2 * heads * d)
    assert torch.equal(tp_join([tp_slice(x, 1, 1, 2, r) for r in range(2)], 1, 1), x)


def test_check_batch_divisibility():
    assert check_batch_divisibility(8, 1, 8) == 8
    assert check_batch_divisibility(32, 2, 8) == 16
    assert check_batch_divisibility(16, 2, 16) == 8
    with pytest.raises(ValueError, match="not divisible by process_count"):
        check_batch_divisibility(9, 2, 4)
    with pytest.raises(ValueError, match="not divisible by the"):
        check_batch_divisibility(12, 1, 8)
    with pytest.raises(ValueError, match="not divisible by the"):
        check_batch_divisibility(4, 1, 8)


def test_initialize_distributed_gating(monkeypatch):
    """No-op for a plain run (torchrun's one-process WORLD_SIZE=1 too);
    torchrun's WORLD_SIZE > 1, SLURM, Open MPI or any kwarg joins, and a
    failure propagates; rank and world size come from the environment."""
    calls = []

    def fake_init(**kw):
        calls.append(kw)
        raise RuntimeError("rendezvous unreachable")

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    for var in ("WORLD_SIZE", "RANK", "SLURM_JOB_ID", "SLURM_NTASKS", "SLURM_PROCID", "OMPI_COMM_WORLD_SIZE",
                "OMPI_COMM_WORLD_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh_mod.initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert mesh_mod.initialize_distributed() is False
    assert calls == []
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(RuntimeError):
        mesh_mod.initialize_distributed(backend="gloo")
    assert calls[-1] == {"backend": "gloo", "init_method": "env://", "world_size": 4, "rank": 3}
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    monkeypatch.setenv("SLURM_JOB_ID", "1234")
    monkeypatch.setenv("SLURM_NTASKS", "2")
    monkeypatch.setenv("SLURM_PROCID", "1")
    with pytest.raises(RuntimeError):
        mesh_mod.initialize_distributed(backend="nccl")
    assert calls[-1] == {"backend": "nccl", "init_method": "env://", "world_size": 2, "rank": 1}
    for var in ("SLURM_JOB_ID", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var)
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError):
        mesh_mod.initialize_distributed(backend="gloo")
    monkeypatch.delenv("OMPI_COMM_WORLD_SIZE")
    with pytest.raises(RuntimeError):  # explicit kwargs are a request too
        mesh_mod.initialize_distributed(backend="gloo", init_method="tcp://10.0.0.1:1234", world_size=2, rank=0)
    assert calls[-1]["init_method"] == "tcp://10.0.0.1:1234"
    assert len(calls) == 4


def test_mesh_of_one_process_and_bad_shapes():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "fsdp": 1, "tp": 1} and mesh.world == 1
    assert (mesh.batch_shards, mesh.batch_rank) == (1, 0)
    assert all(g is None for g in mesh.groups.values())
    with pytest.raises(ValueError, match="mesh 0x2x1 != 1 processes"):
        make_mesh(fsdp=2, device="cpu")


@pytest.mark.parametrize("length", [7, 8])
def test_eval_batches_shard_and_pad(length):
    """Two shards of a ragged set: disjoint, covering it, the same number of
    whole batches each, padded entries flagged by pad_mask; one shard
    unpadded is the old walk in order."""
    ds = Dummy(image_shape=(28, 28), length=length)
    seen = []
    counts = []
    for shard in range(2):
        batches = list(eval_batches(ds, 2, 2, shard))
        counts.append(len(batches))
        for b in batches:
            assert b["image"].shape[0] == 2
            seen += [img.tobytes() for img, keep in zip(b["image"], b["pad_mask"]) if keep]
    assert counts == [2, 2] and len(seen) == length
    whole = [img.tobytes() for b in eval_batches(ds, 3) for img in b["image"]]
    assert sorted(seen) == sorted(whole) and len(whole) == length

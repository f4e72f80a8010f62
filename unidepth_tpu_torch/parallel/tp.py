"""Tensor parallelism in the models: ``shard_model_`` swaps each Linear that
``tp_param_sharding`` splits for this rank's slice and sets the local head
counts (counterpart of the JAX package's tp layout, where GSPMD partitions
the same modules).

* ``ViTBlock`` (``models/backbones/dinov2.py``): ``attn.qkv`` column, a
  rank's heads of each of q, k and v, so K1 runs on the local heads;
  ``attn.proj`` row; ``mlp.fc1`` column (K2 at F / tp) and ``mlp.fc2`` row.
* ``ConvNeXtBlock`` (``models/backbones/convnext.py``): ``mlp.fc1`` column
  (K2), ``mlp.fc2`` row.
* ``MLP`` (``nn/layers.py``): ``proj1`` column, ``proj2`` row.
* ``AttentionBlock`` and ``NystromBlock`` (``nn/layers.py``,
  ``nn/nystrom.py``): ``q`` and ``kv`` column (a rank's heads of k and of
  v), ``out`` row; K3 on the local heads; each rank adds its heads' columns
  of the full-width positional embeddings.

A column-parallel input is replicated over tp: ``copy_to_tp`` all-reduces
its gradient, which each rank holds only in part (including a LayerNorm's
weight and bias where K2 fuses the norm into the product). A row-parallel
output is ``reduce_from_tp``: the partial sums all-reduced, then the bias.
What ``tp_param_sharding`` leaves whole runs replicated, with the same
numbers on every tp rank.
"""

from __future__ import annotations

import torch.nn as nn

from unidepth_tpu_torch.models.backbones.convnext import ConvNeXtBlock
from unidepth_tpu_torch.models.backbones.dinov2 import ViTBlock, _Mlp
from unidepth_tpu_torch.nn.layers import MLP, AttentionBlock
from unidepth_tpu_torch.ops.quant import QuantLinear
from unidepth_tpu_torch.parallel.mesh import (
    ColumnParallelLinear,
    Mesh,
    RowParallelLinear,
    Split,
    param_layouts,
    tp_param_sharding,
)

__all__ = ["shard_model_"]


def _whole_modules(model: nn.Module, tp: int) -> set[str]:
    """The modules named like a tp projection that must stay whole: those
    whose forward cannot run on a slice (a head count or a GRN that tp
    does not divide, a conv, a Linear outside the blocks that know tp)."""
    splittable, whole = set(), set()  # splittable: the Linears whose forward runs on a slice
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, QuantLinear):
            raise ValueError(f"shard_model_: {name} is int8; tensor parallelism takes the bf16 / fp32 model")
        if isinstance(mod, ViTBlock):
            if mod.num_heads % tp == 0:
                splittable |= {pre + "attn.qkv", pre + "attn.proj"}
            if isinstance(mod.mlp, _Mlp):
                splittable |= {pre + "mlp.fc1", pre + "mlp.fc2"}
        elif isinstance(mod, ConvNeXtBlock):
            if mod.mlp.grn is None:  # GRN normalises over every hidden channel
                splittable |= {pre + "mlp.fc1", pre + "mlp.fc2"}
        elif isinstance(mod, MLP):
            splittable |= {pre + "proj1", pre + "proj2"}
        elif isinstance(mod, AttentionBlock) and mod.num_heads % tp == 0:
            splittable |= {pre + "q", pre + "kv", pre + "out"}
    for name, mod in model.named_modules():
        # the rule matches a parameter by its owner's name: a module named
        # like a projection that owns weights (a conv, a Linear elsewhere)
        if name.rsplit(".", 1)[-1] in ("qkv", "fc1", "q", "kv", "proj1", "proj", "fc2", "out", "proj2") \
                and name not in splittable and any(True for _ in mod.parameters(recurse=False)):
            whole.add(name)
    return whole


def shard_model_(model: nn.Module, mesh: Mesh) -> dict[str, Split]:
    """Split ``model`` (whole, as built) over ``mesh``'s tp axis in place and
    return every parameter's ``Split`` (``tp_param_sharding`` with the
    modules that must stay whole; ``fsdp_param_sharding``'s rule where
    nothing is tp-split). Every rank must hold the same whole weights."""
    tp = mesh.shape["tp"]
    whole = _whole_modules(model, tp)
    named = dict(model.named_parameters())
    splits = tp_param_sharding(mesh, named, layouts=param_layouts(model), whole=whole)
    if tp == 1:
        return splits
    modules = dict(model.named_modules())
    pairs = {"qkv": "proj", "fc1": "fc2", "q": "out", "kv": "out", "proj1": "proj2"}
    for name, mod in list(modules.items()):
        split = splits.get(f"{name}.weight")
        if not isinstance(mod, nn.Linear) or split is None or split.tp is None:
            continue
        head, _, leaf = name.rpartition(".")
        if leaf in pairs:  # a column split needs its row partner split too
            partner = splits.get(f"{head}.{pairs[leaf]}.weight" if head else f"{pairs[leaf]}.weight")
            if partner is None or partner.tp is None:
                raise ValueError(f"shard_model_: {name} splits over tp but its partner {pairs[leaf]} does not")
        cls = ColumnParallelLinear if split.tp == 0 else RowParallelLinear
        parent = modules[head] if head else model
        setattr(parent, leaf, cls.from_linear(mod, split, mesh))
    for mod in model.modules():
        if isinstance(mod, ViTBlock) and isinstance(mod.attn.qkv, ColumnParallelLinear):
            mod.num_heads //= tp
        elif isinstance(mod, AttentionBlock) and isinstance(mod.q, ColumnParallelLinear):
            mod.num_heads //= tp
    return splits

"""Process groups, sharding rules and collectives (counterpart of
unidepth_tpu/parallel/mesh.py, which lays one ``jax.sharding.Mesh`` over
the devices and lets GSPMD insert the communication).

Here one process drives one device, and the mesh is a grid of
``torch.distributed`` process groups over the ranks: ``data`` (data
parallelism, the reference's only strategy), ``fsdp`` (ZeRO-3-style shards
of the float32 masters, Adam moments and EMA shadow) and ``tp`` (Megatron
column / row tensor parallelism), ``tp`` innermost so that rank
``(d * fsdp + f) * tp + t`` holds coordinates ``(d, f, t)``. The
communication is explicit:

* the batch is split over ``data`` x ``fsdp`` (``batch_shards``,
  ``batch_rank``); tp peers see the same rows;
* ``copy_to_tp`` / ``reduce_from_tp``: the two Megatron autograd functions
  around a column-then-row pair (identity forward and all-reduce backward;
  all-reduce forward and identity backward), which ``ColumnParallelLinear``
  and ``RowParallelLinear`` apply; ``tp_inputs`` and ``tp_columns`` are
  what a model layer asks of a Linear that may be column-parallel (no-ops
  for any other);
* ``Layout``: each parameter's split (``Split``), the FSDP all-gather of
  the masters into the model, the gradients' mean over the batch axes
  (reduce-scattered over ``fsdp``), the global norm over the shards, and
  whole tensors for a checkpoint;
* ``batch_sharded``: serving with each batch rank on its rows, the outputs
  all-gathered.

The backend is the caller's: ``nccl`` on the card, ``gloo`` on the CPU (and
for two ranks sharing one card, which NCCL refuses). Gloo has no
reduce-scatter on CUDA tensors, so there the collectives take an all-reduce
and keep their slice (``_reduce_scatter``); the result is the same.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections.abc import Mapping

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "AXES",
    "ColumnParallelLinear",
    "FSDP_MIN_SIZE",
    "Layout",
    "Mesh",
    "Split",
    "all_gather_cat",
    "batch_sharded",
    "check_batch_divisibility",
    "copy_to_tp",
    "fsdp_param_sharding",
    "initialize_distributed",
    "make_mesh",
    "param_layouts",
    "reduce_from_tp",
    "RowParallelLinear",
    "tp_columns",
    "tp_inputs",
    "tp_param_sharding",
]

AXES = ("data", "fsdp", "tp")

# FSDP spreads large weights; leaves below this element count stay whole
# on every rank (the JAX rule's floor, parallel/mesh.py _FSDP_MIN_SIZE).
FSDP_MIN_SIZE = 1024 * 1024

# Megatron's layout by module name (the parameter's parent): column-parallel
# modules split their output features over tp, row-parallel ones their input
# features (each rank's product is a partial sum, all-reduced once).
_TP_COL = frozenset({"qkv", "fc1", "q", "kv", "proj1"})
_TP_ROW = frozenset({"proj", "fc2", "out", "proj2"})
# fused projections whose output is [q | k | v] or [k | v], each (heads, D):
# a rank keeps its heads of every block, not one contiguous slice
_TP_BLOCKS = {"qkv": 3, "kv": 2}

# the flax kernel axis a of a torch weight is torch dim _FLAX_DIMS[kind][a]:
# Linear (out, in) against (in, out); Conv2d (out, in, kh, kw) against (kh, kw,
# in, out); ConvTranspose2d (in, out, kh, kw) against (kh, kw, in, out)
_FLAX_DIMS = {"linear": (1, 0), "conv": (2, 3, 1, 0), "conv_transpose": (2, 3, 0, 1)}


# ---------------------------------------------------------------------------
# start-up
# ---------------------------------------------------------------------------


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize_distributed(backend: str | None = None, **kwargs) -> bool:
    """Join the process group when a multi-process run is asked for; returns
    whether it did.

    A no-op for a plain run. The signs of a cluster are torchrun's
    ``WORLD_SIZE`` > 1, ``SLURM_JOB_ID``, ``OMPI_COMM_WORLD_SIZE``, or any
    keyword argument (``init_method``, ``world_size``, ``rank``, ``store``,
    ... of ``torch.distributed.init_process_group``). Then failures
    propagate: a misconfigured job fails at start instead of running as N
    independent single-process jobs. ``backend`` defaults to ``nccl`` where
    a card is present and ``gloo`` elsewhere; nothing is tried and dropped.
    Rank and world size come from the kwargs, else torchrun's, SLURM's or
    Open MPI's variables; the rendezvous from ``init_method`` (default
    ``env://``: ``MASTER_ADDR`` and ``MASTER_PORT``).
    """
    world = _env_int("WORLD_SIZE")
    wants_cluster = (
        bool(kwargs)
        or (world or 1) > 1
        or any(os.environ.get(v) for v in ("SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE"))
    )
    if not wants_cluster:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(kwargs)
    if "store" not in kw:
        kw.setdefault("init_method", "env://")
    if "world_size" not in kw:
        ws = _env_int("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE")
        if ws is not None:
            kw["world_size"] = ws
    if "rank" not in kw:
        rk = _env_int("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")
        if rk is not None:
            kw["rank"] = rk
    dist.init_process_group(backend=backend, **kw)
    return True


def check_batch_divisibility(batch_size: int, n_proc: int, n_dev: int) -> int:
    """Validate the global batch against the process/device topology and
    return the per-process batch (a copy of the JAX rule). Fails fast at
    start-up when the batch would not split evenly.

    ``n_dev`` is the global count of batch shards (data x fsdp); the check
    is on the global batch, ``batch_size % n_dev == 0``, and
    ``batch_size % n_proc == 0`` for the per-process slice."""
    if batch_size % n_proc != 0:
        raise ValueError(f"batch_size {batch_size} not divisible by process_count {n_proc}")
    if batch_size % n_dev != 0:
        # no silent rounding-up: inflating to the device count would run a
        # larger global batch than configured
        raise ValueError(
            f"global batch {batch_size} not divisible by the {n_dev} batch-shard devices; pick a batch_size that "
            f"is a multiple of both the device count and the process count"
        )
    return batch_size // n_proc


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Mesh:
    """This rank's place in a data x fsdp x tp grid of processes.

    ``groups`` maps a tuple of axes (in ``AXES`` order) to the process group
    of the ranks that differ only along those axes, or to None where that
    group is this rank alone (every collective over it is a no-op)."""

    shape: dict[str, int]
    coords: dict[str, int]
    device: torch.device
    groups: dict[tuple[str, ...], object]

    @property
    def world(self) -> int:
        return self.size(*AXES)

    def size(self, *axes: str) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, *axes: str) -> int:
        """This rank's index within the group of ``axes`` (mixed radix, the
        first axis outermost)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, *axes: str):
        return self.groups[tuple(a for a in AXES if a in axes)]

    @property
    def batch_shards(self) -> int:
        """How many slices the batch is cut into: data x fsdp."""
        return self.size("data", "fsdp")

    @property
    def batch_rank(self) -> int:
        """Which slice of the batch this rank holds (tp peers share it)."""
        return self.index("data", "fsdp")


def _rank_of(shape: dict, coords: dict) -> int:
    return (coords["data"] * shape["fsdp"] + coords["fsdp"]) * shape["tp"] + coords["tp"]


def make_mesh(data: int | None = None, fsdp: int = 1, tp: int = 1, device=None) -> Mesh:
    """The data x fsdp x tp mesh over the ranks of the default process group
    (one rank when it is not initialised), ``tp`` innermost so that its
    per-block all-reduces run between neighbouring ranks, ``data``
    outermost. ``data`` defaults to what the world size leaves.

    Every rank must call it, in the same order as any other group creation.
    ``device``: this rank's device; by default the card ``cuda:(LOCAL_RANK
    % device_count())``, ``"cpu"`` (or any device) where the caller asks."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if data is None:
        data = world // (fsdp * tp)
    if data * fsdp * tp != world:
        raise ValueError(f"mesh {data}x{fsdp}x{tp} != {world} processes")
    shape = {"data": data, "fsdp": fsdp, "tp": tp}
    coords = {"data": rank // (fsdp * tp), "fsdp": rank // tp % fsdp, "tp": rank % tp}
    groups: dict[tuple[str, ...], object] = {}
    for axes in (("data",), ("fsdp",), ("tp",), ("data", "fsdp"), ("data", "tp"), ("fsdp", "tp"),
                 ("data", "fsdp", "tp")):
        n = math.prod(shape[a] for a in axes)
        if n == 1:
            groups[axes] = None
            continue
        if n == world:
            groups[axes] = dist.group.WORLD
            continue
        rest = [a for a in AXES if a not in axes]
        mine = None
        # every rank creates every group, in one order
        for fixed in np.ndindex(*(shape[a] for a in rest)):
            ranks = []
            for varying in np.ndindex(*(shape[a] for a in axes)):
                c = dict(zip(rest, fixed)) | dict(zip(axes, varying))
                ranks.append(_rank_of(shape, c))
            g = dist.new_group(ranks)
            if rank in ranks:
                mine = g
        groups[axes] = mine
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' for a CPU run")
        local = _env_int("LOCAL_RANK")
        device = torch.device("cuda", (rank if local is None else local) % torch.cuda.device_count())
    return Mesh(shape=shape, coords=coords, device=torch.device(device), groups=groups)


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Split:
    """One parameter's layout: ``tp``, the torch dim split over the tp axis
    (None: whole on every tp rank), holding ``blocks`` equal blocks that are
    each split alike (qkv: 3, kv: 2); ``fsdp``, the torch dim split over the
    fsdp axis (None: whole on every fsdp rank)."""

    tp: int | None = None
    fsdp: int | None = None
    blocks: int = 1


def param_layouts(model: torch.nn.Module) -> dict[str, str]:
    """The kind of each weight of ``model`` (``linear``, ``conv``,
    ``conv_transpose``), by parameter name: the rules' translation to the
    flax kernel layout."""
    kinds = {torch.nn.Linear: "linear", torch.nn.Conv2d: "conv", torch.nn.ConvTranspose2d: "conv_transpose"}
    out = {}
    for name, mod in model.named_modules():
        for cls, kind in kinds.items():
            if isinstance(mod, cls):
                out[f"{name}.weight" if name else "weight"] = kind
    return out


def _flax_dims(name: str, shape: tuple, layouts: Mapping) -> tuple[int, ...]:
    return _FLAX_DIMS.get(layouts.get(name), tuple(range(len(shape))))


def _shapes(params: Mapping) -> dict[str, tuple]:
    return {n: tuple(getattr(p, "shape", p)) for n, p in params.items()}


def _mesh_shape(mesh) -> dict[str, int]:
    return dict(mesh if isinstance(mesh, Mapping) else mesh.shape)


def _fsdp_dim(name, shape, fsdp, layouts) -> int | None:
    """The JAX shape rule on the flax layout: the largest axis (the first of
    equals) over fsdp when it divides, nothing below the size floor."""
    if fsdp == 1 or len(shape) == 0 or math.prod(shape) < FSDP_MIN_SIZE:
        return None
    dims = _flax_dims(name, shape, layouts)
    flax = [shape[d] for d in dims]
    axis = int(np.argmax(flax))
    return dims[axis] if flax[axis] % fsdp == 0 else None


def fsdp_param_sharding(mesh, params: Mapping, layouts: Mapping) -> dict[str, Split]:
    """Each parameter's largest axis over the fsdp axis when it divides
    evenly and the tensor holds at least ``FSDP_MIN_SIZE`` elements; whole
    otherwise.

    ``mesh``: a Mesh, or a mapping of axis sizes; ``params``: name -> tensor
    or shape. Shape-driven, so the Adam moments and the EMA shadow take
    their parameter's layout. The rule is the JAX package's on the flax
    layout of each weight (``layouts``: ``param_layouts(model)``): the axis
    is chosen there and translated, so a square Linear splits its input
    features, as the flax (in, out) kernel splits its axis 0."""
    fsdp = _mesh_shape(mesh).get("fsdp", 1)
    return {n: Split(fsdp=_fsdp_dim(n, s, fsdp, layouts)) for n, s in _shapes(params).items()}


def tp_param_sharding(mesh, params: Mapping, layouts: Mapping, whole=()) -> dict[str, Split]:
    """Tensor-parallel + fsdp layout (the JAX rule, translated to torch).

    Column-parallel modules (``qkv``, ``fc1``, ``q``, ``kv``, ``proj1``)
    split their output features over tp, weight dim 0 and bias; row-parallel
    ones (``proj``, ``fc2``, ``out``, ``proj2``) the input features, weight
    dim 1, with the bias whole (added once after the all-reduce). The tp
    split takes a rank's heads of each of q, k and v (``Split.blocks``). A
    tp-split weight of at least ``FSDP_MIN_SIZE`` elements also splits its
    largest remaining axis over fsdp when that divides (2-D tp x fsdp).
    Everything else follows ``fsdp_param_sharding``. ``layouts``:
    ``param_layouts(model)``.

    ``whole``: module names whose parameters stay whole over tp. The model
    surgery (``parallel.tp.shard_model_``) names there a module whose heads
    or hidden size tp does not divide, or whose forward cannot run on a
    slice (a ConvNeXt-V2 GRN block), e.g. the V1 decoder's one-head D = 512
    attention. JAX's GSPMD splits such a module inside the head and
    contracts with an all-reduce: that changes the layout, not the
    results, so keeping it whole gives the same numbers."""
    shape = _mesh_shape(mesh)
    tp, fsdp = shape.get("tp", 1), shape.get("fsdp", 1)
    whole = tuple(whole)
    out = {}
    for name, s in _shapes(params).items():
        parts = name.split(".")
        leaf, parent = parts[-1], parts[-2] if len(parts) >= 2 else ""
        module = ".".join(parts[:-1])
        axis = None
        if tp > 1 and s and not any(module == w or module.startswith(w + ".") for w in whole):
            if parent in _TP_COL and leaf in ("weight", "bias"):
                axis = len(s) - 1  # output features: the flax kernel's last axis
            elif parent in _TP_ROW and leaf == "weight" and len(s) >= 2:
                axis = len(s) - 2  # input features: the contraction axis
        dims = _flax_dims(name, s, layouts)
        if axis is not None and s[dims[axis]] % tp == 0:
            flax = [s[d] for d in dims]
            fsdp_dim = None
            # 2-D (tp x fsdp) only above the pure fsdp rule's size floor
            if fsdp > 1 and len(s) >= 2 and math.prod(s) >= FSDP_MIN_SIZE:
                size, fa = max((flax[a], a) for a in range(len(s)) if a != axis)
                if size % fsdp == 0:
                    fsdp_dim = dims[fa]
            blocks = _TP_BLOCKS.get(parent, 1) if parent in _TP_COL else 1
            out[name] = Split(tp=dims[axis], fsdp=fsdp_dim, blocks=blocks)
        else:
            out[name] = Split(fsdp=_fsdp_dim(name, s, fsdp, layouts))
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _gloo_cuda(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) joined along ``dim`` in group-rank
    order; ``t`` itself when the group is this rank alone."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    t = t.contiguous()
    if dist.get_backend(group) == "gloo":  # gloo gathers into a list, the form it has for CUDA tensors
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
    else:
        stacked = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(stacked, t, group=group)
        parts = stacked.unbind(0)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of ``t`` (leading dim divisible by the group
    size), this rank's slice of the leading dim. Gloo has no reduce-scatter
    for CUDA tensors: there it is an all-reduce and the slice."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    t = t.contiguous()
    if _gloo_cuda(group, t):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t.chunk(n)[i].clone()
    out = torch.empty((t.shape[0] // n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product (replicated on the tp ranks):
    identity forward, the gradient all-reduced over ``group`` backward (each
    rank's is a partial sum over its output features)."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel product: the ranks' partial sums
    all-reduced forward, the gradient passed through backward."""
    return x if group is None else _ReduceFromTP.apply(x, group)


# ---------------------------------------------------------------------------
# the state on the mesh
# ---------------------------------------------------------------------------


def tp_slice(t: torch.Tensor, dim: int, blocks: int, tp: int, index: int) -> torch.Tensor:
    """Rank ``index``'s slice of ``t`` along ``dim`` of ``tp``: the
    ``index``-th of ``tp`` equal parts of each of ``blocks`` equal blocks."""
    u = t.unflatten(dim, (blocks, -1))
    n = u.shape[dim + 1] // tp
    return u.narrow(dim + 1, index * n, n).flatten(dim, dim + 1)


def tp_join(pieces: list[torch.Tensor], dim: int, blocks: int) -> torch.Tensor:
    """The inverse of ``tp_slice`` over every rank's piece, in rank order."""
    parts = [p.unflatten(dim, (blocks, -1)) for p in pieces]
    return torch.cat(parts, dim=dim + 1).flatten(dim, dim + 1)


class _ParallelLinear(torch.nn.Linear):
    """A Linear holding one tp rank's slice of a whole Linear."""

    tp_group = None
    tp_size = 1
    tp_rank = 0

    @classmethod
    def from_linear(cls, linear: torch.nn.Linear, split: Split, mesh: Mesh) -> "_ParallelLinear":
        tp, rank = mesh.shape["tp"], mesh.coords["tp"]
        w = tp_slice(linear.weight.detach(), split.tp, split.blocks, tp, rank)
        bias = linear.bias
        if bias is not None and cls is ColumnParallelLinear:
            bias = tp_slice(bias.detach(), 0, split.blocks, tp, rank)
        new = cls(w.shape[1], w.shape[0], bias=bias is not None, device=w.device, dtype=w.dtype)
        with torch.no_grad():
            new.weight.copy_(w)
            if bias is not None:
                new.bias.copy_(bias)
        new.tp_group, new.tp_size, new.tp_rank = mesh.group("tp"), tp, rank
        return new


class ColumnParallelLinear(_ParallelLinear):
    """The rank's output features; the (replicated) input goes through
    ``copy_to_tp``."""

    def forward(self, x):
        return torch.nn.functional.linear(copy_to_tp(x, self.tp_group), self.weight, self.bias)


class RowParallelLinear(_ParallelLinear):
    """The rank's input features: the partial products summed over tp, then
    the whole bias."""

    def forward(self, x):
        y = reduce_from_tp(torch.nn.functional.linear(x, self.weight), self.tp_group)
        return y if self.bias is None else y + self.bias


def tp_inputs(linear: torch.nn.Module, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``tensors`` through ``copy_to_tp`` when ``linear`` is column-parallel
    (the replicated inputs of a kernel that takes the weight itself: K2's x
    and LayerNorm parameters), else as they are."""
    if not isinstance(linear, ColumnParallelLinear):
        return tensors
    return tuple(copy_to_tp(t, linear.tp_group) for t in tensors)


def tp_columns(linear: torch.nn.Module, t: torch.Tensor) -> torch.Tensor:
    """The last-dim columns of a full-width ``t`` that a column-parallel
    ``linear`` computes (its heads of a positional embedding added to its
    output), through ``copy_to_tp``; ``t`` itself for any other module."""
    if not isinstance(linear, ColumnParallelLinear):
        return t
    return tp_slice(copy_to_tp(t, linear.tp_group), t.ndim - 1, 1, linear.tp_size, linear.tp_rank)


class Layout:
    """Where each named tensor of a parameter dict lives on ``mesh``
    (``splits``: name -> Split) and the collectives that move it.

    "Local" tensors have the shape of the rank's model parameters (tp-split
    modules hold their slice); "shards" are the local tensors cut over fsdp
    where the split names a dim, what the train state holds."""

    def __init__(self, mesh: Mesh, splits: dict[str, Split]):
        self.mesh, self.splits = mesh, splits
        self.fsdp = mesh.shape["fsdp"]
        self.tp = mesh.shape["tp"]

    def _fsdp_dim(self, name: str) -> int | None:
        return self.splits[name].fsdp if self.fsdp > 1 else None

    def shard(self, local: dict) -> dict:
        """Each local tensor's fsdp shard (a copy, so the whole tensor can
        be freed)."""
        i = self.mesh.coords["fsdp"]
        out = {}
        for n, t in local.items():
            d = self._fsdp_dim(n)
            out[n] = t.detach().clone() if d is None else t.detach().chunk(self.fsdp, d)[i].clone()
        return out

    def gather(self, shards: dict, dtype: torch.dtype | None = None) -> dict:
        """The local tensors from their shards (an all-gather over fsdp each;
        cast to ``dtype`` first when given, which gathers fewer bytes)."""
        group = self.mesh.group("fsdp")
        out = {}
        for n, t in shards.items():
            t = t if dtype is None else t.to(dtype)
            d = self._fsdp_dim(n)
            out[n] = t if d is None else all_gather_cat(t, group, dim=d)
        return out

    @torch.no_grad()
    def load_into(self, params: dict, shards: dict) -> None:
        """Copy the gathered shards into the model's parameters ``params``
        (name -> Parameter), in their dtype."""
        for n, p in params.items():
            d = self._fsdp_dim(n)
            t = shards[n]
            if d is not None:
                t = all_gather_cat(t.to(p.dtype), self.mesh.group("fsdp"), dim=d)
            p.copy_(t)

    def _sum_axes(self, name: str) -> tuple[str, ...]:
        """The axes a gradient is averaged over by all-reduce: the batch
        axes (data alone where fsdp reduce-scatters it), and tp for a tensor
        whole on the tp ranks, whose copies agree in exact arithmetic but
        not bit for bit where a kernel's backward accumulates in a racing
        order (atomics): averaging keeps the replicas equal."""
        axes = ("data",) if self._fsdp_dim(name) is not None else ("data", "fsdp")
        return axes + ("tp",) if self.tp > 1 and self.splits[name].tp is None else axes

    @torch.no_grad()
    def reduce_grads(self, grads: dict) -> dict:
        """The mean over the batch axes (data x fsdp) of each rank's local
        gradient: reduce-scattered over fsdp where the split names a dim,
        then all-reduced over data; the others all-reduced over data x fsdp
        in one flat buffer; a tensor whole over tp averaged over tp too.
        Returns the gradients' shards."""
        mesh = self.mesh
        out: dict = {}
        buckets: dict[tuple[str, ...], list[str]] = {}
        for n in grads:
            if self._fsdp_dim(n) is None:
                buckets.setdefault(self._sum_axes(n), []).append(n)
        for axes, names in buckets.items():
            group = mesh.group(*axes)
            tensors = [grads[n] for n in names]
            if group is not None:
                flat = torch.cat([t.reshape(-1) for t in tensors])
                dist.all_reduce(flat, group=group)
                tensors = [r.view_as(t) for r, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
            torch._foreach_div_(tensors, float(mesh.size(*axes)))
            out.update(zip(names, tensors))
        for n, g in grads.items():
            d = self._fsdp_dim(n)
            if d is None:
                continue
            s = _reduce_scatter(g.movedim(d, 0), mesh.group("fsdp"))
            axes = self._sum_axes(n)
            if mesh.group(*axes) is not None:
                dist.all_reduce(s, group=mesh.group(*axes))
            out[n] = s.movedim(0, d).div_(float(mesh.size("fsdp", *axes))).contiguous()
        return {n: out[n] for n in grads}

    def _counted(self, name: str) -> bool:
        """Whether this rank adds ``name``'s shard to a global sum over
        fsdp x tp: a tensor whole over an axis counts on that axis's rank 0
        alone, so each element counts once."""
        s, c = self.splits[name], self.mesh.coords
        return (s.fsdp is not None and self.fsdp > 1 or c["fsdp"] == 0) and (s.tp is not None or c["tp"] == 0)

    def global_norm(self, shards: dict) -> torch.Tensor:
        """sqrt of the sum of squares over every element of every tensor
        (``optax.global_norm`` of the whole tree), from the shards."""
        mine = [t for n, t in shards.items() if self._counted(n)]
        ref = next(iter(shards.values()))
        sq = (torch.stack(torch._foreach_norm(mine)).square().sum() if mine
              else torch.zeros((), dtype=ref.dtype, device=ref.device))
        group = self.mesh.group("fsdp", "tp")
        if group is not None:
            dist.all_reduce(sq, group=group)
        return sq.sqrt()

    def full(self, shards: dict) -> dict:
        """The whole tensors (the model's as one process holds it), on every
        rank, moved to the CPU one by one."""
        out = {}
        group = self.mesh.group("tp")
        for n, t in self.gather(shards).items():
            s = self.splits[n]
            if s.tp is not None and self.tp > 1:
                t = tp_join(list(all_gather_cat(t[None], group).unbind(0)), s.tp, s.blocks)
            out[n] = t.cpu()
        return out

    def from_full(self, full: dict, like: dict) -> dict:
        """This rank's shards of the whole tensors ``full``, placed like the
        shards ``like`` (device and dtype)."""
        c = self.mesh.coords
        out = {}
        for n, t in full.items():
            s = self.splits[n]
            if s.tp is not None and self.tp > 1:
                t = tp_slice(t, s.tp, s.blocks, self.tp, c["tp"])
            d = self._fsdp_dim(n)
            if d is not None:
                t = t.chunk(self.fsdp, d)[c["fsdp"]]
            out[n] = t.to(like[n].device, like[n].dtype).clone()
        return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def batch_sharded(fn, mesh: Mesh, *tensors, **kwargs) -> dict:
    """``fn(*rows, **kwargs)`` on this rank's rows of each batch tensor (the
    batch split over data x fsdp, tp peers sharing their rows), every output
    tensor all-gathered back into the whole batch in order. Tensor kwargs
    with the batch's leading size are split alike; other outputs are the
    local call's. The batch must divide by the batch shards."""
    b = tensors[0].shape[0]
    n, r = mesh.batch_shards, mesh.batch_rank
    local = check_batch_divisibility(b, n, n)

    def rows(v):
        return v[r * local : (r + 1) * local] if (torch.is_tensor(v) or isinstance(v, np.ndarray)) \
            and v.ndim and v.shape[0] == b else v

    out = fn(*(rows(t) for t in tensors), **{k: rows(v) for k, v in kwargs.items()})
    group = mesh.group("data", "fsdp")
    return {k: all_gather_cat(v, group) if torch.is_tensor(v) and v.ndim and v.shape[0] == local else v
            for k, v in out.items()}

"""CUDA graphs of a model's serving stages, one per input signature.

``UniDepthV2.infer()`` and ``UniDepthV1.infer()`` open ``serving(store)``
around their two stages; the stages' forwards (the encoders ``DinoViT`` and
``ConvNeXt``, the V2 ``Decoder`` and ``DecoderV1``) run their bodies
through ``call(module, fn, *args)``:

    with stage_graphs.serving(model._stage_graphs):
        feats, cls_tokens = encoder(x)            # forward -> call(...)
        out = decoder(feats, cls_tokens, (h, w))  # forward -> call(...)

Outside ``serving`` (``encode_decode``, training, ``validate()``, the
exporter, V2old) ``call`` is ``fn(*args)``. The replay happens inside
the module's forward, so forward hooks still fire around it, and a stage's
device time is its replay's.

Inside ``serving``, a call runs eagerly where something is compiled or
exported, where autograd records, where its first tensor is not on a CUDA
device, or where the stream is already being captured, and counts why
(``call.eager``: "export", "grad", "cpu", "capturing"). Otherwise its key is
its module and what its arguments show: their structure, each tensor's
shape, strides, dtype and device, and every other argument's value (an
image shape, ``confidence``, a ``None`` in place of ``rays_gt``). The first
call with a key runs eagerly ("first sight"): it warms the kernels (their
first launch sets their shared-memory attribute), cuBLAS and cuDNN, and its
outputs give the layout the graph's static outputs take. The second call
captures ``fn`` into a CUDA graph on a side stream and replays it on the
current stream; every later call replays (``call.captures``,
``call.replays``). The captured code must not make the host wait on the
device: a constant built from host data is built once, before any capture.

Memory. Every capture shares one private pool, and nothing the store keeps
lives in it: after a capture the pool holds only that capture's transient
working set, which the next capture reuses. A graph reads its inputs from,
and copies its outputs into, static buffers outside the pool, one per role,
shared by every key and grown to the largest. A role is an input or output
storage in the order the stage takes or gives it: the encoder's image; its
outputs, which for DINOv2 are the four stage outputs that hold a feature map
and a cls token each, and for ConvNeXt the four stage maps and the four
tokens, eight storages; V2's decoder's rays; V1's decoder's rays and K at
the network shape (with a given K) and its outputs, K, the three depth maps
and the 1/16 latents. When a buffer grows, every graph of the store is
captured again over the new buffers, at once, so no later call captures.
An input that already lies in a static buffer (the encoder's features, read
by the decoder) is read where it lies; any other is copied in before the
replay. An output that lies in an input's storage (the decoder's ``rays``,
given as ``rays_gt``; V1's K, given as ``K_gt`` with ``skip_camera``) stays
a view of that input's buffer.

The outputs a replayed call returns are views of the static buffers, which
the next replay of any graph may overwrite: the caller consumes them or
copies them (``StageGraphs.detach``) before it leaves ``serving``. A store's
lock lets one thread at a time inside ``serving``; the device then runs the
requests in that order where the threads share a stream (PyTorch's default
one), and not otherwise.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

__all__ = ["StageGraphs", "serving", "call"]

_local = threading.local()


@contextlib.contextmanager
def serving(store: "StageGraphs"):
    """Route the stage calls made in this thread through ``store``, one
    thread at a time."""
    with store.lock:
        outer = getattr(_local, "store", None)
        _local.store = store
        try:
            yield store
        finally:
            _local.store = outer


def call(module, fn, *args):
    """``fn(*args)``, the body of ``module``'s forward: replayed from a CUDA
    graph inside ``serving`` where the route holds (module docstring)."""
    store = getattr(_local, "store", None)
    if store is None:
        return fn(*args)
    return store.call(module, fn, args)


call.captures = 0  # graphs captured (a buffer's growth captures every graph again)
call.replays = 0  # calls served by a replay
call.eager = collections.Counter()  # calls inside ``serving`` run eagerly, by reason


def _flatten(obj, leaves: list):
    """A hashable description of ``obj``: its lists, tuples and dicts, each
    tensor's (shape, strides, dtype, device) and every other value; the
    tensors are appended to ``leaves`` in order."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return (torch.Tensor, tuple(obj.shape), obj.stride(), obj.dtype, obj.device)
    if isinstance(obj, (list, tuple)):
        return (type(obj), tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    return obj


def _unflatten(desc, leaves):
    """``obj`` of ``_flatten``'s description, with its tensors taken in turn
    from the iterator ``leaves``."""
    if isinstance(desc, tuple) and desc:
        kind = desc[0]
        if kind is torch.Tensor:
            return next(leaves)
        if kind in (list, tuple):
            return kind(_unflatten(d, leaves) for d in desc[1])
        if kind is dict:
            return {k: _unflatten(d, leaves) for k, d in desc[1]}
    return desc


def _eager_reason(leaves: list) -> str | None:
    if torch.compiler.is_compiling():
        return "export"
    if torch.is_grad_enabled():
        return "grad"
    if not leaves or leaves[0].device.type != "cuda":
        return "cpu"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


def _body(entry) -> None:
    """What ``entry``'s graph runs: its stage over the static inputs, then
    the copies of its outputs into their static views."""
    out_leaves = []
    _flatten(entry.fn(*_unflatten(entry.desc, iter(entry.static_in))), out_leaves)
    for j in entry.owned_out:
        entry.static_out[j].copy_(out_leaves[j])


def _extent(t: torch.Tensor) -> tuple[int, int]:
    """First and one-past-last byte ``t`` can touch in its storage."""
    size = t.element_size()
    start = t.storage_offset() * size
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride())) if t.numel() else -1
    return start, start + (last + 1) * size


def _groups(tensors) -> tuple[list, list]:
    """Each tensor's (group, byte offset in the group) where tensors sharing
    a storage form a group, and each group's byte size."""
    where, spans, index = [], [], {}
    for t in tensors:
        ptr = t.untyped_storage().data_ptr()
        start, end = _extent(t)
        g = index.setdefault(ptr, len(spans))
        if g == len(spans):
            spans.append([start, end])
        else:
            spans[g] = [min(spans[g][0], start), max(spans[g][1], end)]
        where.append((g, start))
    return [(g, start - spans[g][0]) for g, start in where], [end - start for start, end in spans]


class _View:
    """A static tensor: a view at a byte offset into one of the store's
    buffers, with a tensor's shape, strides and dtype (``_meta``)."""

    __slots__ = ("buffer", "offset", "shape", "stride", "dtype", "itemsize")

    def __init__(self, buffer, offset: int, meta: tuple):
        self.buffer, self.offset = buffer, offset
        self.shape, self.stride, self.dtype, self.itemsize = meta

    def tensor(self, store: "StageGraphs") -> torch.Tensor:
        raw = store.buffers[self.buffer].view(self.dtype)
        return raw.as_strided(self.shape, self.stride, self.offset // self.itemsize)


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype, t.element_size()


class _Entry:
    """One key's graph, its inputs' and outputs' static views, and which
    outputs the graph copies into its own buffers."""

    def __init__(self, fn, desc, inputs: list, out_desc, outputs: list, owned_out: list):
        self.fn, self.desc, self.out_desc = fn, desc, out_desc
        self.inputs, self.outputs, self.owned_out = inputs, outputs, owned_out
        self.graph = self.static_in = self.static_out = None


class StageGraphs:
    """A model's captured stage graphs, their shared pool and static
    buffers. ``clear()`` drops them all (the model's weights moved, its
    kernels or serving precision changed); a copy or a pickle of the model
    carries an empty store."""

    def __init__(self):
        self.lock = threading.RLock()
        self.clear()

    def __reduce__(self):
        return (StageGraphs, ())

    def clear(self) -> None:
        with self.lock:
            self.entries: dict = {}  # key -> _Entry, in capture order
            self.layouts: dict = {}  # key -> the first call's output layout
            self.buffers: dict = {}  # (module, role, group) -> uint8 tensor outside the pool
            self.pool = None
            self._stream = None

    def detach(self, outputs: dict) -> dict:
        """``outputs`` with each tensor that lies in a static buffer copied,
        so that no later call changes it."""
        ptrs = {b.untyped_storage().data_ptr() for b in self.buffers.values()}
        if not ptrs:
            return outputs
        return {k: v.clone() if isinstance(v, torch.Tensor) and v.untyped_storage().data_ptr() in ptrs else v
                for k, v in outputs.items()}

    def call(self, module, fn, args: tuple):
        leaves = []
        desc = _flatten(args, leaves)
        reason = _eager_reason(leaves)
        if reason is not None:
            call.eager[reason] += 1
            return fn(*args)
        key = (module, desc)
        entry = self.entries.get(key)
        if entry is None:
            if key not in self.layouts:
                call.eager["first sight"] += 1
                out = fn(*args)
                self.layouts[key] = self._layout(out, leaves)
                return out
            entry = self._plan(key, module, fn, desc, leaves)
        for t, static in zip(leaves, entry.static_in):
            if t.data_ptr() != static.data_ptr():
                static.copy_(t)
        entry.graph.replay()
        call.replays += 1
        return _unflatten(entry.out_desc, iter(entry.static_out))

    # ------------------------------------------------------------------
    @staticmethod
    def _layout(out, leaves: list):
        """The first call's outputs: their description, each output
        tensor's ``_meta`` and place, either ("input", leaf, byte offset
        from that input's first byte) where it lies in an input's storage or
        ("group", group, byte offset), and the groups' byte sizes. No tensor
        is kept."""
        out_leaves = []
        out_desc = _flatten(out, out_leaves)
        in_ptrs = {t.untyped_storage().data_ptr(): i for i, t in enumerate(leaves)}
        own = [t for t in out_leaves if t.untyped_storage().data_ptr() not in in_ptrs]
        placed, sizes = _groups(own)
        placed = iter(placed)
        where = []
        for t in out_leaves:
            i = in_ptrs.get(t.untyped_storage().data_ptr())
            if i is None:
                where.append((_meta(t), "group", *next(placed)))
            else:
                where.append((_meta(t), "input", i, _extent(t)[0] - _extent(leaves[i])[0]))
        return out_desc, where, sizes

    def _buffer(self, name, nbytes: int, device) -> bool:
        """Make buffer ``name`` hold ``nbytes``; True if that replaced one a
        graph may read or write."""
        buf = self.buffers.get(name)
        if buf is not None and buf.numel() >= nbytes:
            return False
        self.buffers[name] = torch.empty(-(-nbytes // 16) * 16, dtype=torch.uint8, device=device)
        return buf is not None

    def _plan(self, key, module, fn, desc, leaves: list) -> _Entry:
        """The second call with ``key``: its static views, its buffers grown
        where they must (every graph captured again then), its capture."""
        out_desc, where, sizes = self.layouts.pop(key)
        device = leaves[0].device
        others = {b.untyped_storage().data_ptr(): name for name, b in self.buffers.items() if name[0] is not module}
        inputs, own = [None] * len(leaves), []
        for i, t in enumerate(leaves):
            name = others.get(t.untyped_storage().data_ptr())
            if name is not None:  # another stage's static output, read where it lies
                inputs[i] = _View(name, _extent(t)[0], _meta(t))
            else:
                own.append(i)
        placed, in_sizes = _groups([leaves[i] for i in own])
        grew = False
        for g, nbytes in enumerate(in_sizes):
            grew |= self._buffer((module, "in", g), nbytes, device)
        for i, (g, offset) in zip(own, placed):
            inputs[i] = _View((module, "in", g), offset, _meta(leaves[i]))
        for g, nbytes in enumerate(sizes):
            grew |= self._buffer((module, "out", g), nbytes, device)
        outputs, owned_out = [], []
        for j, (meta, kind, *place) in enumerate(where):
            if kind == "input":
                v = inputs[place[0]]
                outputs.append(_View(v.buffer, v.offset + place[1], meta))
            else:
                outputs.append(_View((module, "out", place[0]), place[1], meta))
                owned_out.append(j)
        entry = _Entry(fn, desc, inputs, out_desc, outputs, owned_out)
        if grew:
            for other in self.entries.values():
                self._capture(other, device)
        self._capture(entry, device)
        self.entries[key] = entry
        return entry

    def _capture(self, entry: _Entry, device) -> None:
        """Capture ``entry.fn`` over its static inputs into a graph that ends
        by copying its outputs into their static views."""
        entry.static_in = [v.tensor(self) for v in entry.inputs]
        entry.static_out = [v.tensor(self) for v in entry.outputs]
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                _body(entry)
            finally:
                graph.capture_end()
        current.wait_stream(self._stream)
        entry.graph = graph
        call.captures += 1

"""Batch assembly and feeding (the counterpart of
unidepth_tpu/datasets/loader.py).

  * ``ShapeSampler`` draws one image shape a batch within the model's shape
    constraints (every sample of a batch shares it; shapes are multiples of
    14 and few, so the kernels see few token counts);
  * ``WeightedConcat`` draws a child dataset by weight (``get_weights``:
    its size's cube root times the config's multiplier), then an index;
  * ``Loader`` decodes and augments on host threads and yields collated
    numpy batches; with ``shape_seed`` batch n's shape depends on
    (shape_seed, n) alone and batches come in order n;
  * ``device_prefetch`` moves them to the card through page-locked memory
    on a side stream, ``size`` batches ahead of the consumer;
  * ``collate`` stacks equal-shape samples into channel-last numpy arrays,
    with rays from the port's cameras; ``make_batch`` draws one optimizer
    step from one fixed-shape dataset (the Dummy path); ``eval_batches``
    walks a dataset, or a rank's shard of it padded to the batches every
    rank runs, in order for validation.
"""

from __future__ import annotations

import collections
import queue
import threading
import warnings
from typing import Sequence

import numpy as np
import torch

from unidepth_tpu_torch.datasets.samplers import ShardedEvalSampler
from unidepth_tpu_torch.geometry.cameras import CAMERA_TYPE_IDS, BatchCamera, Pinhole

__all__ = ["Loader", "ShapeSampler", "WeightedConcat", "collate", "device_prefetch", "eval_batches", "get_weights",
           "make_batch"]


class ShapeSampler:
    """One global image shape a batch: ``num_shapes`` (height, width) pairs
    drawn once from ``seed`` within the constraints (ratio and pixel bounds,
    multiples of ``shape_mult``), one of them a batch."""

    def __init__(self, constraints: dict, num_shapes: int = 8, seed: int = 0):
        self.c = constraints
        rng = np.random.default_rng(seed)
        mult = constraints.get("shape_mult", 14)
        self.shapes = []
        for _ in range(num_shapes):
            ratio = rng.uniform(*constraints["ratio_bounds"])
            pixels = rng.uniform(constraints["pixels_min"], constraints["pixels_max"])
            h = int(round((pixels / ratio) ** 0.5 / mult)) * mult
            w = int(round((pixels * ratio) ** 0.5 / mult)) * mult
            h = max(h, -(-constraints.get("height_min", 15) // mult) * mult)
            w = max(w, -(-constraints.get("width_min", 15) // mult) * mult)
            self.shapes.append((h, w))

    def sample(self, rng: np.random.Generator) -> tuple[int, int]:
        if not self.c.get("sample", True):
            return self.shapes[0]
        return self.shapes[int(rng.integers(0, len(self.shapes)))]


def get_weights(datasets: Sequence, sampling: dict | None = None) -> np.ndarray:
    """Each dataset's sampling weight: its size's cube root times the
    config's multiplier for its name (``sampling``), normalised."""
    sizes = np.asarray([len(d) for d in datasets], np.float64)
    w = np.power(sizes, 1.0 / 3.0)
    if sampling:
        names = [d.spec.name if hasattr(d, "spec") else d.__class__.__name__ for d in datasets]
        w = w * np.asarray([sampling.get(n, 1.0) for n in names])
    return w / w.sum()


class WeightedConcat:
    def __init__(self, datasets: Sequence, weights: np.ndarray | None = None, sampling=None):
        self.datasets = list(datasets)
        self.weights = weights if weights is not None else get_weights(self.datasets, sampling)

    def sample(self, rng: np.random.Generator):
        di = int(rng.choice(len(self.datasets), p=self.weights))
        ds = self.datasets[di]
        idx = int(rng.integers(0, len(ds)))
        return ds, idx


def collate(samples: list[dict]) -> dict:
    """Stack equal-shape samples into a channel-last numpy batch; images stay
    raw 0..255 floats (the train step normalises on the device)."""
    imgs = np.stack([s["image"] for s in samples]).astype(np.float32)
    h, w = imgs.shape[1:3]
    depth = np.stack([s["depth"] for s in samples])[..., None].astype(np.float32)
    mask = np.stack([s.get("depth_mask", s["depth"] > 0) for s in samples])[..., None]
    validity = np.stack([s.get("validity", np.ones((h, w), bool)) for s in samples])[..., None].astype(np.float32)
    K = np.stack([s["K"] for s in samples]).astype(np.float32)
    models = [s.get("camera_model", "Pinhole") for s in samples]
    if set(models) == {"Pinhole"}:
        cam = Pinhole.from_K(torch.from_numpy(K))
    else:
        # each camera from its params vector, padded to 16 (the dataset
        # pipeline keeps it in step with every crop and resize)
        params = np.zeros((len(samples), 16), np.float32)
        for i, s in enumerate(samples):
            cp = np.asarray(s.get("camera_params", K[i, [0, 1, 0, 1], [0, 1, 2, 2]]), np.float32)
            params[i, : cp.shape[0]] = cp
        cam = BatchCamera(torch.from_numpy(params), torch.tensor([CAMERA_TYPE_IDS[m] for m in models]))
    rays = cam.get_rays(h, w).reshape(len(samples), h * w, 3).numpy()
    return {
        "image": imgs,
        "depth": depth,
        "depth_mask": mask,
        "validity_mask": validity,
        "K": K,
        "rays": rays,
        "si": np.asarray([float(s.get("si", False)) for s in samples], np.float32),
        "ssi": np.asarray([float(s.get("ssi", False)) for s in samples], np.float32),
        "dense": np.asarray([float(s.get("dense", False)) for s in samples], np.float32),
        "quality": np.asarray([int(s.get("quality", 0)) for s in samples], np.int32),
        "flips": np.asarray([bool(s.get("flip", False)) for s in samples]),
    }


def make_batch(dataset, batch_size: int, accum: int, rng: np.random.Generator, num_copies: int = 1) -> dict:
    """One optimizer step's batch from ``dataset`` (indexable, one shape):
    leaves (accum, batch_size, ...), or (batch_size, ...) when ``accum`` is
    1; each index drawn from ``rng`` and taken ``num_copies`` times in a
    row."""
    if batch_size % num_copies:
        raise ValueError(f"batch_size {batch_size} not divisible by num_copies {num_copies}")
    micro = []
    for _ in range(accum):
        samples = []
        for _ in range(batch_size // num_copies):
            idx = int(rng.integers(0, len(dataset)))
            samples.extend(dataset[idx] for _ in range(num_copies))
        micro.append(collate(samples))
    if accum == 1:
        return micro[0]
    return {k: np.stack([m[k] for m in micro]) for k in micro[0]}


def eval_batches(dataset, batch_size: int, num_shards: int = 1, shard_id: int = 0, pad: bool | None = None):
    """Collated batches of shard ``shard_id`` of ``num_shards`` of
    ``dataset`` (``ShardedEvalSampler``: indices shard_id, shard_id +
    num_shards, ...) in index order.

    Unpadded (the default for one shard) the last batch is ragged. Padded
    (always over several shards) every shard yields the same number of
    whole batches, ceil(ceil(len / num_shards) / batch_size): the missing
    entries repeat the shard's last sample and carry ``pad_mask`` False, so
    their metrics are dropped, and ranks whose forward communicates
    (tensor parallelism) run the same batches (the JAX trainer's
    ``_val_loaders``)."""
    idxs = list(ShardedEvalSampler(len(dataset), num_shards, shard_id))
    if not (num_shards > 1 if pad is None else pad):
        for b in range(0, len(idxs), batch_size):
            yield collate([dataset[i] for i in idxs[b : b + batch_size]])
        return
    n_valid = len(idxs)
    n_batches = -(-(-(-len(dataset) // num_shards)) // batch_size)
    idxs += [idxs[-1] if idxs else 0] * (n_batches * batch_size - n_valid)
    for b in range(n_batches):
        batch = collate([dataset[i] for i in idxs[b * batch_size : (b + 1) * batch_size]])
        batch["pad_mask"] = np.arange(b * batch_size, (b + 1) * batch_size) < n_valid
        yield batch


class _WorkerDied:
    """Queue sentinel carrying a dead worker's exception to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class Loader:
    """Threaded loader yielding collated numpy batches: leaves (batch, ...),
    or (accum, batch, ...) when ``accum`` > 1. ``num_threads`` 0 builds the
    batches in the consumer's thread from one ``seed``ed generator: a
    reproducible stream."""

    def __init__(
        self,
        dataset: WeightedConcat,
        batch_size: int,
        shape_sampler: ShapeSampler | None = None,
        accum: int = 1,
        num_threads: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        num_copies: int = 1,
        shape_seed: int | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shape_sampler = shape_sampler
        self.accum = accum
        if batch_size % num_copies != 0:
            raise ValueError(f"batch_size {batch_size} not divisible by num_copies {num_copies}")
        self.num_copies = num_copies
        # a multi-frame draw is a list of samples, which collate cannot
        # stack: refuse it here rather than kill every worker later
        for ds in getattr(dataset, "datasets", [dataset]):
            if getattr(ds, "num_frames", 1) > 1:
                raise ValueError(f"{type(ds).__name__} has num_frames={ds.num_frames}; the batch Loader supports "
                                 "only single-frame samples")
        if num_copies > 1:
            # the copies of a sample must be augmented independently: a
            # dataset with only __getitem__ yields identical copies, and the
            # self-distillation loss degenerates to ~0
            bad = [type(ds).__name__ for ds in getattr(dataset, "datasets", [dataset])
                   if not hasattr(ds, "get_single_item")]
            if bad:
                warnings.warn(f"num_copies={num_copies} but dataset(s) {bad} expose only __getitem__ (no "
                              "get_single_item): copies of a sample will be identical and the self-distillation "
                              "loss degenerates to ~0", stacklevel=2)
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.seed = seed
        self.shape_seed = shape_seed
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._counter = 0
        self._lock = threading.Lock()
        # ordered mode: at most num_threads + prefetch tickets in flight, so
        # the consumer's stash of early batches stays bounded
        self._window = threading.BoundedSemaphore(num_threads + prefetch)
        # the consumer's ticket and stash live on the loader: workers never
        # re-issue a ticket, so a second iter(loader) continues the stream
        self._next_ticket = 0
        self._stash: dict[int, dict] = {}

    @property
    def _ordered(self) -> bool:
        return self.shape_seed is not None and self.shape_sampler is not None

    def shape_for_batch(self, n: int) -> tuple[int, int]:
        """Batch ``n``'s shape in ordered mode: a function of (shape_seed, n)."""
        return self.shape_sampler.sample(np.random.default_rng([int(self.shape_seed), int(n)]))

    def _make_batch(self, rng: np.random.Generator, ticket: int | None = None) -> dict | None:
        """One batch; None when the loader stops while it is built (a batch
        of large samples takes seconds, longer than ``close()`` waits)."""
        if self._ordered and ticket is not None:
            shape = self.shape_for_batch(ticket)
        else:
            shape = self.shape_sampler.sample(rng) if self.shape_sampler else None
        micro = []
        for _ in range(self.accum):
            samples = []
            for _ in range(self.batch_size // self.num_copies):
                if self._stop.is_set():
                    return None
                # num_copies > 1: one base sample, num_copies independent
                # crops and augmentations, interleaved (SelfDistill's layout)
                ds, idx = self.dataset.sample(rng)
                samples.extend(self._fetch_copies(ds, idx, rng, shape))
            micro.append(collate(samples))
        if self.accum == 1:
            return micro[0]
        return {k: np.stack([m[k] for m in micro]) for k in micro[0]}

    def _fetch_copies(self, ds, idx, rng, shape) -> list[dict]:
        """``num_copies`` draws of one sample, retried with a random index
        on any error, so that a bad sample does not kill a worker."""
        for _ in range(8):
            try:
                base = ds.read_base(idx) if self.num_copies > 1 and hasattr(ds, "read_base") else None
                out = []
                for _ in range(self.num_copies):
                    if base is not None:
                        out.append(ds.get_single_item(idx, rng, image_shape=shape, base=base))
                    elif hasattr(ds, "get_single_item"):
                        out.append(ds.get_single_item(idx, rng, image_shape=shape))
                    else:
                        out.append(ds[idx])
                return out
            except Exception:
                idx = int(rng.integers(0, len(ds)))
        raise RuntimeError(f"loader: failed to fetch any sample from {ds}")

    def _put(self, item) -> bool:
        """Offer ``item`` until it is taken or the loader stops."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, tid: int):
        rng = np.random.default_rng(self.seed + 1000 * tid)
        try:
            while not self._stop.is_set():
                ticket = None
                if self._ordered:
                    while not self._stop.is_set():
                        if self._window.acquire(timeout=1.0):
                            break
                    else:
                        return
                    with self._lock:
                        ticket = self._counter
                        self._counter += 1
                batch = self._make_batch(rng, ticket)
                # keep offering the same batch: dropping a built batch on a
                # full queue would burn host time rebuilding it
                if batch is None or not self._put((ticket, batch) if self._ordered else batch):
                    return
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer, which raises it
            self._put(_WorkerDied(e))

    def __iter__(self):
        if self._stop.is_set():
            raise RuntimeError("loader is closed (close() was called)")
        if self.num_threads <= 0:
            rng = np.random.default_rng(self.seed)
            n = 0
            while True:
                yield self._make_batch(rng, n)
                n += 1
        if not self._threads:
            for t in range(self.num_threads):
                th = threading.Thread(target=self._worker, args=(t,), daemon=True)
                th.start()
                self._threads.append(th)
        while True:
            # ordered mode: release batches strictly by ticket
            if self._ordered and self._next_ticket in self._stash:
                batch = self._stash.pop(self._next_ticket)
                self._next_ticket += 1
                self._window.release()
                yield batch
                continue
            item = self._q.get()
            if isinstance(item, _WorkerDied):
                raise RuntimeError("loader worker thread died; training would hang waiting for batches") \
                    from item.error
            if self._ordered:
                ticket, batch = item
                self._stash[ticket] = batch
                continue
            yield item

    def close(self):
        """Stop and join the worker threads (they poll the stop flag each
        second and before each sample, so this takes at most ~3 s; a thread
        still alive is kept)."""
        self._stop.set()
        alive = []
        for t in self._threads:
            t.join(timeout=3.0)
            if t.is_alive():
                alive.append(t)
        self._threads[:] = alive


def device_prefetch(iterator, device, size: int = 2):
    """Yield the batches of ``iterator`` (dicts of numpy arrays) as tensors
    on ``device``, ``size`` batches ahead. On the card each leaf is copied
    into page-locked memory and sent with a non-blocking copy on a side
    stream; the consumer's stream waits on the copy's event before it is
    handed the batch, and each tensor is recorded on that stream so its
    memory outlives its use there (PyTorch's pinned allocator reuses a
    page-locked buffer only after the copy that read it has run). On another
    device the leaves are moved as they are, with no pinning."""
    device = torch.device(device)
    pending = collections.deque()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        if side is None:
            pending.append(({k: torch.as_tensor(v).to(device) for k, v in batch.items()}, None))
            return
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(side)
        pending.append((out, done))

    def take():
        out, done = pending.popleft()
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in out.values():
                t.record_stream(consumer)
        return out

    it = iter(iterator)
    for batch in it:
        put(batch)
        if len(pending) > size:
            yield take()
    while pending:
        yield take()

"""The validation driver (counterpart of unidepth_tpu/utils/validation.py):
runs the model's eval forward over validation loaders, computes the
per-sample metrics on the model's device and averages them on the host.
Over several processes each rank validates its shard of each dataset
(``datasets.loader.eval_batches``) and the per-sample metrics are
all-gathered before the mean, as the JAX package's ``process_allgather``
does: the shards are ragged, so each is padded with NaN to the longest and
the mean skips NaN (the padded samples of the last batch are NaN too).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from unidepth_tpu_torch.utils.evaluation import eval_3d, eval_depth
from unidepth_tpu_torch.utils.misc import normalize_rgb

__all__ = ["WORLD", "MetricAccumulator", "points_3d", "validate"]


WORLD = "world"  # the default process group when one with more than one rank is up


def _resolve_group(group):
    if group != WORLD:
        return group
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def _gather_values(local: np.ndarray, group) -> np.ndarray:
    """Every rank's ``local`` (float64, ragged), each padded with NaN to the
    longest, concatenated in rank order."""
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" else "cpu"
    n = torch.tensor([local.size], dtype=torch.int64, device=device)
    dist.all_reduce(n, op=dist.ReduceOp.MAX, group=group)
    padded = np.full(int(n.item()), np.nan)
    padded[: local.size] = local
    t = torch.from_numpy(padded).to(device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts).cpu().numpy()


class MetricAccumulator:
    """A dataset's per-sample metrics, averaged by ``get_evaluation`` over
    the ranks of ``group`` (``WORLD``: every rank, when more than one runs;
    None: this process alone)."""

    def __init__(self, name: str, max_depth: float | None = None, group=WORLD):
        self.name = name
        self.max_depth = max_depth
        self.group = _resolve_group(group)
        self._values: dict[str, list[np.ndarray]] = defaultdict(list)

    def accumulate(self, depth_gt, depth_pred, mask, points_gt=None, points_pred=None, thresholds=None, mask3d=None,
                   sample_mask=None):
        """``sample_mask``: optional (B,) bool; False marks padding samples,
        whose metrics are stored as NaN and dropped by the mean."""

        def store(k, v):
            v = v.detach().double().cpu().numpy()
            if sample_mask is not None:
                v = np.where(np.asarray(sample_mask, bool), v, np.nan)
            self._values[k].append(v)

        for k, v in eval_depth(depth_gt, depth_pred, mask, max_depth=self.max_depth).items():
            store(k, v)
        if points_gt is not None and points_pred is not None:
            for k, v in eval_3d(points_gt, points_pred, mask if mask3d is None else mask3d, thresholds).items():
                store(k, v)

    def get_evaluation(self) -> dict[str, float]:
        out = {}
        for k, vs in self._values.items():
            local = np.concatenate([np.atleast_1d(v) for v in vs])
            if self.group is not None:
                local = _gather_values(local, self.group)
            out[k] = float(np.nanmean(local)) if np.any(np.isfinite(local)) else float("nan")
        self._values.clear()
        return out


def points_3d(rays_gt, depth_gt, depth, mask, rays_pred=None) -> dict:
    """The 3-D metrics' inputs for a batch: rays (B, H*W, 3), depths and
    mask (B, H, W, 1). GT depth goes along the GT rays, the prediction along
    its own rays (the GT's when ``rays_pred`` is None), each scaled to unit
    z, both strided so that no cloud exceeds ~240 x 320 points. Returns the
    keyword arguments ``MetricAccumulator.accumulate`` takes, without the
    thresholds."""
    b, h, w = depth.shape[:3]
    s = max(1, int(np.ceil((h * w / (240.0 * 320.0)) ** 0.5)))
    rays_gt = rays_gt.reshape(b, h, w, 3)[:, ::s, ::s]
    rays_pr = rays_gt if rays_pred is None else rays_pred.reshape(b, h, w, 3)[:, ::s, ::s].float()
    return dict(points_gt=rays_gt / rays_gt[..., 2:3].abs().clamp_min(1e-5) * depth_gt[:, ::s, ::s],
                points_pred=rays_pr / rays_pr[..., 2:3].abs().clamp_min(1e-5) * depth[:, ::s, ::s],
                mask3d=mask[:, ::s, ::s])


def validate(model, val_loaders: dict, max_iters: int | None = None, with_3d: bool = False,
             depth_ranges: dict | None = None, group=WORLD) -> dict:
    """val_loaders: {name: iterable of collated numpy batches (raw 0..255
    images)}. Returns {dataset: {metric: value}}.

    The forward is ``model.encode_decode`` on the ImageNet-normalised batch
    and the GT rays, under ``torch.inference_mode`` on the model's device.
    ``with_3d`` adds the Chamfer distance and F1-AUC over 100 log-spaced
    thresholds between the dataset's min_depth and max_depth / 20 on the
    clouds of ``points_3d``. ``group``: the ranks whose loaders hold the
    shards of each dataset (``WORLD``: every rank, when more than one runs);
    each rank must run the same number of batches where the forward itself
    communicates (tensor parallelism)."""
    device = next(model.parameters()).device
    results = {}
    with torch.inference_mode():
        for name, loader in val_loaders.items():
            acc = MetricAccumulator(name, group=group)
            dmin, dmax = (depth_ranges or {}).get(name, (0.01, 80.0))
            thresholds = torch.exp(torch.linspace(float(np.log(dmin)), float(np.log(dmax / 20.0)), 100, device=device))
            for i, batch in enumerate(loader):
                if max_iters is not None and i >= max_iters:
                    break
                image, rays, depth_gt, mask = (torch.as_tensor(batch[k]).to(device)
                                               for k in ("image", "rays", "depth", "depth_mask"))
                out = model.encode_decode(normalize_rgb(image.float()), rays_gt=rays)
                depth = out["depth"].float()
                kwargs = {}
                if with_3d:
                    kwargs = dict(points_3d(rays, depth_gt, depth, mask, out.get("rays")), thresholds=thresholds)
                acc.accumulate(depth_gt, depth, mask, sample_mask=batch.get("pad_mask"), **kwargs)
            results[name] = acc.get_evaluation()
    return results

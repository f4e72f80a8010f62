"""Depth and 3-D evaluation metrics (counterpart of
unidepth_tpu/utils/evaluation.py).

Every metric is a masked reduction over each sample's whole map, batched
over the samples: d1/d2/d3, rmse, rmselog, arel, sqrel, log10, silog,
medianlog, d_auc, tau (3%), the ssi- and si-rescaled d1, tau and arel, and
the 3-D Chamfer distance and F1-AUC through ``ops.knn``.
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.ops.knn import nn_distances
from unidepth_tpu_torch.ops.resize import resize
from unidepth_tpu_torch.training.losses import masked_mean, masked_median

__all__ = ["DEPTH_METRICS", "eval_3d", "eval_depth"]

DEPTH_METRICS = (
    "d1", "d2", "d3", "rmse", "rmselog", "arel", "sqrel", "log10",
    "silog", "medianlog", "tau", "d_auc",
    "d1_ssi", "tau_ssi", "arel_ssi", "d1_si", "tau_si", "arel_si",
)


def _mean(x, m):
    """Per-sample masked mean of (B, N) -> (B,)."""
    return masked_mean(x, m, axis=-1, keepdims=False)


def _masked_std(x, m):
    """The unbiased masked standard deviation (torch.std's estimator)."""
    mean = _mean(x, m)
    var = _mean(torch.square(x - mean[:, None]), m)
    n = m.float().sum(-1).clamp_min(2.0)
    return torch.sqrt(var * n / (n - 1.0))


def _inlier(gt, pred):
    return torch.maximum(gt / pred, pred / gt)


def _delta(gt, pred, m, exponent):
    return _mean((_inlier(gt, pred) < 1.25**exponent).float(), m)


def _tau(gt, pred, m, perc=0.03):
    return _mean((_inlier(gt, pred) < 1.0 + perc).float(), m)


def _ssi_rescale(gt, pred, m):
    """Least-squares scale and shift of pred onto gt over the mask."""
    mf = m.float()
    sw, sx, sxx = mf.sum(-1), (pred * mf).sum(-1), (pred * pred * mf).sum(-1)
    sy, sxy = (gt * mf).sum(-1), (pred * gt * mf).sum(-1)
    det = sxx * sw - sx * sx + 1e-9
    scale = (sxy * sw - sx * sy) / det
    shift = (sxx * sy - sx * sxy) / det
    return pred * scale[:, None] + shift[:, None]


def _si_rescale(gt, pred, m):
    return pred * (masked_median(gt, m, axis=-1) / masked_median(pred, m, axis=-1).clamp_min(1e-9))[:, None]


def _metrics(gt, pred, m):
    """gt, pred (B, N) float32, m (B, N) bool -> {metric: (B,)}."""
    m = m & (gt > 0) & (pred > 0)
    gt = torch.where(m, gt, 1.0)
    pred = torch.where(m, pred, 1.0)
    log_diff = torch.log(pred) - torch.log(gt)
    out = {
        "d1": _delta(gt, pred, m, 1.0),
        "d2": _delta(gt, pred, m, 2.0),
        "d3": _delta(gt, pred, m, 3.0),
        "rmse": torch.sqrt(_mean(torch.square(gt - pred), m)),
        "rmselog": torch.sqrt(_mean(torch.square(log_diff), m)),
        "arel": _mean(torch.abs(gt - pred) / gt, m),
        "sqrel": _mean(torch.square(gt - pred) / gt, m),
        "log10": _mean(torch.abs(torch.log10(pred) - torch.log10(gt)), m),
        "silog": 100.0 * _masked_std(log_diff, m),
        "medianlog": 100.0 * torch.abs(masked_median(log_diff, m, axis=-1)),
        "tau": _tau(gt, pred, m),
    }
    # d_auc: the delta curve over 100 exponents in [0.01, 5], integrated
    exps = torch.linspace(0.01, 5.0, 100, device=gt.device)
    inlier = _inlier(gt, pred)
    deltas = torch.stack([_mean((inlier < t).float(), m) for t in torch.pow(1.25, exps)], dim=-1)
    out["d_auc"] = torch.trapezoid(deltas, exps, dim=-1) / 5.0
    for name, rescale in (("ssi", _ssi_rescale), ("si", _si_rescale)):
        p = torch.where(m, rescale(gt, pred, m), 1.0).clamp_min(1e-9)
        out[f"d1_{name}"] = _delta(gt, p, m, 1.0)
        out[f"tau_{name}"] = _tau(gt, p, m)
        out[f"arel_{name}"] = _mean(torch.abs(gt - p) / gt, m)
    return out


def eval_depth(gts, preds, masks, max_depth=None) -> dict:
    """gts, preds (B, H, W, 1), masks bool -> {metric: (B,)}. Predictions on
    another grid are resized bilinearly to the GT's first."""
    if preds.shape[1:3] != gts.shape[1:3]:
        preds = resize(preds, tuple(gts.shape[1:3]), mode="bilinear", align_corners=False)
    if max_depth is not None:
        masks = masks & (gts <= max_depth)
    b = gts.shape[0]
    return _metrics(gts.reshape(b, -1).float(), preds.reshape(b, -1).float(), masks.reshape(b, -1).bool())


def eval_3d(gt_points, pred_points, masks, thresholds) -> dict:
    """gt and pred points (B, H, W, 3), masks (B, H, W, 1) bool, thresholds
    (T,) -> {"chamfer": (B,), "F1": (B,)}: the symmetric Chamfer distance
    over the masked points and the F1 curve over the thresholds (against
    squared distances, as in JAX), integrated and divided by T."""
    b = gt_points.shape[0]
    gp, pp = gt_points.reshape(b, -1, 3), pred_points.reshape(b, -1, 3)
    mv = masks.reshape(b, -1).bool()
    thresholds = torch.as_tensor(thresholds, dtype=torch.float32, device=gp.device)
    chamfer, f1 = [], []
    for g, p, m in zip(gp, pp, mv):
        d_gp, _ = nn_distances(g, p, x_valid=m, y_valid=m)
        d_pg, _ = nn_distances(p, g, x_valid=m, y_valid=m)
        n = m.float().sum().clamp_min(1.0)
        chamfer.append(((torch.sqrt(d_gp) + torch.sqrt(d_pg)) / 2.0 * m).sum() / n)
        prec = ((d_pg[None] < thresholds[:, None]) & m).sum(-1) / n
        rec = ((d_gp[None] < thresholds[:, None]) & m).sum(-1) / n
        f1s = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
        f1.append(torch.trapezoid(f1s, dx=1.0) / thresholds.shape[0])
    return {"chamfer": torch.stack(chamfer), "F1": torch.stack(f1)}

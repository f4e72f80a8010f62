"""Visualisation helpers (counterpart of part of
unidepth_tpu/utils/visualization.py): ``colorize`` through a fixed magma
lookup table (no plotting dependency), ``image_grid`` for comparison panels,
``log_train_artifacts``, the training-artifact grid, and
``save_point_cloud``, an ASCII PLY writer.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["colorize", "image_grid", "log_train_artifacts", "save_point_cloud"]


def _magma_lut(n: int = 256) -> np.ndarray:
    # compact piecewise-linear fit of matplotlib's magma endpoints
    anchors = np.asarray(
        [
            (0.001462, 0.000466, 0.013866),
            (0.316654, 0.071690, 0.485380),
            (0.716387, 0.214982, 0.475290),
            (0.986700, 0.535582, 0.382210),
            (0.987053, 0.991438, 0.749504),
        ]
    )
    xs = np.linspace(0, 1, len(anchors))
    xi = np.linspace(0, 1, n)
    return np.stack(
        [np.interp(xi, xs, anchors[:, c]) for c in range(3)], axis=-1
    )


_LUTS = {"magma": _magma_lut(), "magma_r": _magma_lut()[::-1]}


def colorize(
    value: np.ndarray,
    vmin: float | None = None,
    vmax: float | None = None,
    cmap: str = "magma_r",
) -> np.ndarray:
    """(H, W) depth/err map -> (H, W, 3) uint8. Invalid (<=0) pixels black."""
    value = np.asarray(value, np.float64).squeeze()
    invalid = ~np.isfinite(value) | (value <= 0)
    valid = ~invalid
    if vmin is None:
        vmin = np.percentile(value[valid], 2) if valid.any() else 0.0
    if vmax is None:
        vmax = np.percentile(value[valid], 98) if valid.any() else 1.0
    x = np.clip((value - vmin) / max(vmax - vmin, 1e-9), 0.0, 1.0)
    lut = _LUTS.get(cmap, _LUTS["magma_r"])
    rgb = lut[(x * (len(lut) - 1)).astype(np.int32)]
    rgb[invalid] = 0.0
    return (rgb * 255).astype(np.uint8)


def image_grid(images: list[np.ndarray], rows: int, cols: int) -> np.ndarray:
    """Stack equal-size (H, W, 3) images into a (rows*H, cols*W, 3) grid."""
    h, w = images[0].shape[:2]
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, img in enumerate(images[: rows * cols]):
        r, c = divmod(i, cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    return grid


def _to_u8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        if img.min() < 0:  # [-1, 1]-normalised (the reference's convention)
            img = (127.5 * (img + 1.0)).clip(0, 255)
        elif img.max() <= 1.0 + 1e-6:
            img = img * 255.0
        img = img.clip(0, 255).astype(np.uint8)
    return img


def log_train_artifacts(rgbs, gts, preds, out_path=None, infos: dict | None = None) -> np.ndarray:
    """The training-artifact grid: one column a sample; rows rgb, colorized
    GT, the prediction scale-and-shift aligned to the GT and colorized on
    the GT's range, then ``infos``' maps (name -> list of (H, W[, 3])
    arrays). Without GT the prediction is colorized on [0, 80]. ``rgbs``:
    (H, W, 3) uint8 or float images; ``gts``/``preds``: (H, W[, 1]) depth
    maps (numpy or tensors). Writes ``out_path`` as a PNG when given
    (``utils/png.py``); returns the uint8 grid (pair it with
    ``MetricLogger.log_image``)."""
    from unidepth_tpu_torch.training.losses import ssi_helper

    def host(x):
        return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    rgbs = [_to_u8(host(r)) for r in rgbs]
    cols = len(rgbs)
    gts = [host(g).squeeze() for g in gts]
    preds = [host(p).squeeze() for p in preds]
    gt_rows, pred_rows = [], []
    if len(gts):
        for gt, pred in zip(gts, preds):
            valid = gt > 0
            if valid.any():
                scale, shift = ssi_helper(torch.from_numpy(pred[valid].astype(np.float32)),
                                          torch.from_numpy(gt[valid].astype(np.float32)))
                pred = pred * float(scale) + float(shift)
                vmin, vmax = float(gt[valid].min()), float(gt.max())
            else:
                vmin, vmax = 0.0, 0.1
            gt_rows.append(colorize(gt, vmin=vmin, vmax=vmax))
            pred_rows.append(colorize(pred, vmin=vmin, vmax=vmax))
    else:
        pred_rows = [colorize(p, 0.0, 80.0) for p in preds]
    extra = []
    for info in (infos or {}).values():
        for x in list(info)[:cols]:
            x = host(x)
            extra.append(_to_u8(x) if x.ndim == 3 and x.shape[-1] == 3 else colorize(x))
    rows = 2 + int(len(gt_rows) > 0) + len(infos or {})
    grid = image_grid([*rgbs, *gt_rows, *pred_rows, *extra], rows, cols)
    if out_path is not None:
        from unidepth_tpu_torch.utils.png import write_png

        write_png(out_path, grid)
    return grid


_PLY_CHUNK = 1 << 16  # rows formatted by one % operation


def save_point_cloud(path, points, colors=None) -> None:
    """points (N, 3) float, colors (N, 3) uint8 -> an ASCII PLY, byte for byte
    the JAX writer's: its header, then one row a point of ``%.5f``
    coordinates and, with colours, three integers. Rows are formatted a
    chunk at a time by one ``%`` over a repeated row format, on the float64
    widening of the values (exact, as the f-string's is; ``%d`` of a colour
    held in a float64 is its integer)."""
    points = np.asarray(points).reshape(-1, 3)
    n = len(points)
    row = "%.5f %.5f %.5f"
    values = points.astype(np.float64)
    header = "ply\nformat ascii 1.0\n" f"element vertex {n}\n" "property float x\nproperty float y\nproperty float z\n"
    if colors is not None:
        values = np.concatenate([values, np.asarray(colors).reshape(-1, 3).astype(np.uint8)], axis=1)
        row += " %d %d %d"
        header += "property uchar red\nproperty uchar green\nproperty uchar blue\n"
    row += "\n"
    with open(path, "w") as f:
        f.write(header + "end_header\n")
        for i in range(0, n, _PLY_CHUNK):
            chunk = values[i : i + _PLY_CHUNK]
            f.write(row * len(chunk) % tuple(chunk.reshape(-1).tolist()))

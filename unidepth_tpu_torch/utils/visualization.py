"""Visualisation helpers (counterpart of part of
unidepth_tpu/utils/visualization.py): ``colorize`` through a fixed magma
lookup table (no plotting dependency) and ``image_grid`` for comparison
panels. ``log_train_artifacts`` and ``save_point_cloud`` are not ported yet
(ROADMAP A9).
"""

from __future__ import annotations

import numpy as np

__all__ = ["colorize", "image_grid"]


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

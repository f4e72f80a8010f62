"""Host-side data transforms in numpy (the counterpart of
unidepth_tpu/datasets/pipelines.py, which runs them through PIL): the
transforms the datasets build, and the augmentation library's others
(``Rotate``, the ``ImageEnhance`` and ``ImageOps`` ones, ``RandomColor``,
``RandomShear``, ``RandomTranslate``, ``Normalize``, ``RandomMasking``,
``RandomFiller``, ``masked_nearest_fill``). Each is a callable over a
``sample`` dict (image (H, W, 3) uint8, depth (H, W) float32, K (3, 3)
float32, validity (H, W) bool, flip, ...) and a numpy ``Generator``,
drawing from it in the
JAX transform's order and number, so a seeded pipeline crops and jitters
identically. The cameras follow the pixels (a flip moves cx, a crop shifts
the principal point, a resize scales fx, fy).

The image operations reproduce Pillow's integer arithmetic, so they equal
the JAX package's bit for bit: the resampling (``resize_image``: two
passes, horizontal then vertical, through a uint8 image, with 22-bit
fixed-point coefficients; nearest by a running float64 source position),
``ImageEnhance``'s blends (float32, truncated, clipped to 0..255), the ITU-R
601 grey, the Gaussian blur as three box blurs with fractional edges, the
SMOOTH filter, the HSV conversions and the ``ImageOps`` tables. They stay
in numpy, which releases the interpreter lock on large arrays, so the
loader's threads augment in parallel. The rotation, shear and shift
resample through Pillow, imported at the call: it takes another
nearest-neighbour path for a shift, a fixed-point and a float affine map,
and calling it equals the JAX package by construction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

_PRECISION_BITS = 22  # Pillow's resampling coefficients: 32 - 8 - 2 bits


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coefficients(in_size: int, out_size: int, mode: str) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``: for each
    output pixel its first source pixel (out_size,) and the fixed-point
    weights (out_size, ksize) of the source pixels from there (0 past the
    end of its support)."""
    fn, support = _FILTERS[mode]
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn(((taps[None] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # summed in order, as Pillow sums
        total += w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)), np.trunc(0.5 + w * (1 << _PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _resample_rows(arr: np.ndarray, out_size: int, mode: str) -> np.ndarray:
    """One 8-bit pass of Pillow's resampling along axis 0 of ``arr`` uint8
    (int32 sums, as Pillow's: under 2^31 for 8-bit inputs)."""
    xmin, kk = _coefficients(arr.shape[0], out_size, mode)
    kk = kk.astype(np.int32).reshape(kk.shape + (1,) * (arr.ndim - 1))
    acc = np.full((out_size,) + arr.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    last = arr.shape[0] - 1
    for j in range(kk.shape[1]):
        acc += arr[np.minimum(xmin + j, last)] * kk[:, j]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's nearest scale: the source position starts at half a step and
    advances a step a pixel in float64, truncated (it stays inside)."""
    step = in_size / out_size
    return np.add.accumulate(np.concatenate([[step * 0.5], np.full(out_size - 1, step)])).astype(np.int64)


def resize_image(img: np.ndarray, size: tuple[int, int], mode="bilinear") -> np.ndarray:
    """(H, W[, C]) -> size (h, w), as PIL's ``Image.resize``: 'bilinear' and
    'bicubic' (antialiased; uint8) in two 8-bit passes, horizontal first;
    'nearest' (any dtype) by Pillow's running source position."""
    img = np.asarray(img)
    th, tw = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if mode == "nearest":
        return img[_nearest_index(h, th)][:, _nearest_index(w, tw)]
    if mode not in _FILTERS:
        raise ValueError(f"resize_image: unknown mode {mode!r}")
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or img.ndim == 3 and img.shape[-1] != 3:
        raise ValueError(f"resize_image: '{mode}' takes (H, W) or (H, W, 3) uint8, not {img.dtype} {img.shape}")
    out = img
    if tw != w:
        out = _resample_rows(np.ascontiguousarray(out.swapaxes(0, 1)), tw, mode).swapaxes(0, 1)
    if th != h:
        out = _resample_rows(out, th, mode)
    return np.ascontiguousarray(out) if out is not img else img.copy()


def resize_depth(depth: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize preserving sparse validity."""
    return resize_image(depth, size, mode="nearest")


def resize_nearest_nd(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Nearest resize for (H, W, C) float maps (points, flow): pixel-centre
    index gather."""
    h, w = arr.shape[:2]
    th, tw = size
    ri = np.clip(((np.arange(th) + 0.5) * h / th).astype(int), 0, h - 1)
    ci = np.clip(((np.arange(tw) + 0.5) * w / tw).astype(int), 0, w - 1)
    return arr[ri][:, ci]


def _grey(img: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma of (H, W, 3) uint8, as PIL's ``convert("L")``."""
    rgb = img.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _blend(degenerate: np.ndarray, img: np.ndarray, alpha: float) -> np.ndarray:
    """PIL's ``Image.blend(degenerate, img, alpha)``: float32 interpolation,
    truncated, clipped to 0..255 when extrapolating."""
    alpha = np.float32(alpha)
    if alpha == 0.0:
        return np.array(np.broadcast_to(degenerate, img.shape), np.uint8)
    if alpha == 1.0:
        return img.copy()
    lo = np.asarray(degenerate, np.int32)
    out = lo.astype(np.float32) + alpha * (img.astype(np.int32) - lo).astype(np.float32)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def _box_radius(radius: float) -> np.float32:
    """Pillow's ``_gaussian_blur_radius`` at 3 passes, in its float32 and
    float64 steps: the fractional box radius of a Gaussian of ``radius``."""
    f = np.float32
    r = f(radius)
    sigma2 = r * r / f(3)
    big = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = f(math.floor((float(big) - 1.0) / 2.0))
    a = (f(2) * l + f(1)) * (l * (l + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (l + f(1)) * (l + f(1))))
    return l + a


def _box_blur_rows(arr: np.ndarray, radius: np.float32) -> np.ndarray:
    """One pass of Pillow's box blur along axis 0 of ``arr`` uint8: the
    window of 2r + 1 edge-replicated pixels and the two beyond it at a
    fractional weight, in 24-bit fixed point (uint32, as Pillow's: the
    weights sum to at most 2^24, so no sum wraps)."""
    r = int(radius)
    ww = np.uint32(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = np.uint32(((1 << 24) - (2 * r + 1) * int(ww)) // 2)
    n = arr.shape[0]
    padded = arr[np.clip(np.arange(-r - 1, n + r + 1), 0, n - 1)]
    acc = padded[1 : n + 1].astype(np.uint32)
    for k in range(2, 2 * r + 2):  # the window's 2r + 1 rows (r is 0 or 1 at radii up to 2)
        acc += padded[k : k + n]
    bulk = acc * ww
    bulk += (padded[:n].astype(np.uint32) + padded[2 * r + 2 :]) * fw
    bulk += np.uint32(1 << 23)
    return (bulk >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    """PIL's ``ImageFilter.GaussianBlur(radius)`` of (H, W[, C]) uint8: three
    box blurs along the rows, then three along the columns."""
    box = _box_radius(radius)
    if min(img.shape[:2]) < 2 * int(box) + 2:
        raise ValueError(f"gaussian_blur: image {img.shape[:2]} narrower than its box ({2 * int(box) + 2})")
    out = np.ascontiguousarray(img.swapaxes(0, 1))
    for _ in range(3):
        out = _box_blur_rows(out, box)
    out = np.ascontiguousarray(out.swapaxes(0, 1))
    for _ in range(3):
        out = _box_blur_rows(out, box)
    return np.ascontiguousarray(out)


def _smooth(img: np.ndarray) -> np.ndarray:
    """PIL's ``filter(ImageFilter.SMOOTH)`` of (H, W, 3) uint8: the 3x3
    kernel (1 1 1 / 1 5 1 / 1 1 1) / 13 in float32, each row of three summed
    in order, the rows from the one below to the one above, plus 0.5,
    truncated; the border pixels (and an image under 3 x 3) stay as they
    are."""
    f = np.float32
    k1, k5 = f(1) / f(13), f(5) / f(13)
    x = img.astype(f)
    out = img.copy()

    def row(r, k):
        return (r[:, :-2] * k[0] + r[:, 1:-1] * k[1]) + r[:, 2:] * k[2]

    ss = np.full(x[1:-1, 1:-1].shape, f(0.5), f)
    ss += row(x[2:], (k1, k1, k1))
    ss += row(x[1:-1], (k1, k5, k1))
    ss += row(x[:-2], (k1, k1, k1))
    out[1:-1, 1:-1] = np.clip(ss, 0, 255).astype(np.uint8)
    return out


def _rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("HSV")`` of (H, W, 3) uint8, in its float and double
    steps: s and the channel ratios in float32, the hue's sum and wrap in
    float64 stored to float32, both scaled by 255 and truncated."""
    f32, f64 = np.float32, np.float64
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    maxc = np.maximum(r, np.maximum(g, b))
    minc = np.minimum(r, np.minimum(g, b))
    grey = maxc == minc
    cr = np.where(grey, 1, maxc - minc).astype(f32)
    s = (maxc - minc).astype(f32) / np.maximum(maxc, 1).astype(f32)
    rc, gc, bc = (((maxc - c).astype(f32) / cr).astype(f64) for c in (r, g, b))
    h = np.where(r == maxc, (bc.astype(f32) - gc.astype(f32)).astype(f64),
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)).astype(f32)
    h = np.fmod(h.astype(f64) / 6.0 + 1.0, 1.0).astype(f32)
    uh = np.clip((h.astype(f64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(f64) * 255.0).astype(np.int64), 0, 255)
    return np.stack([np.where(grey, 0, uh), np.where(grey, 0, us), maxc], axis=-1).astype(np.uint8)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of an (H, W, 3) uint8 HSV image: the sector
    and its fraction in float64 (the fraction stored to float32), p, q and t
    rounded in float64 (no value of the uint8 domain falls on a tie, so
    ``np.round`` gives C's ``round``: every HSV triple is checked in the
    tests)."""
    f32, f64 = np.float32, np.float64
    h, s, v = (hsv[..., i] for i in range(3))
    hf = h.astype(f64) * 6.0 / 255.0
    sector = np.floor(hf)
    frac = (hf - sector).astype(f32)
    fs = (s.astype(f64) / 255.0).astype(f32)
    vf = v.astype(f64)

    def level(x):
        return np.clip(np.round(vf * x), 0, 255).astype(np.uint8)

    p = level(1.0 - fs.astype(f64))
    q = level(1.0 - (fs * frac).astype(f64))
    t = level(1.0 - fs.astype(f64) * (1.0 - frac.astype(f64)))
    sel = sector.astype(np.int64) % 6
    rgb = np.stack([np.choose(sel, [v, q, p, p, t, v]), np.choose(sel, [t, v, v, q, p, p]),
                    np.choose(sel, [p, p, t, v, v, q])], axis=-1)
    return np.where((s == 0)[..., None], v[..., None], rgb)


def _band_luts(img: np.ndarray, lut_of) -> np.ndarray:
    """(H, W, 3) uint8 through a 256-entry table a channel, each made by
    ``lut_of`` from that channel's histogram and clipped to 0..255 (PIL's
    ``point`` with the tables of ``ImageOps``)."""
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        lut = np.clip(lut_of(np.bincount(img[..., c].ravel(), minlength=256)), 0, 255).astype(np.uint8)
        out[..., c] = lut[img[..., c]]
    return out


def _autocontrast_lut(hist: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast``'s table (no cutoff): the lowest and highest
    values present stretched to 0 and 255 in float64, truncated."""
    present = np.flatnonzero(hist)
    if present.size == 0 or present[-1] <= present[0]:
        return np.arange(256)
    lo, hi = int(present[0]), int(present[-1])
    scale = 255.0 / (hi - lo)
    offset = -lo * scale
    return np.clip((np.arange(256) * scale + offset).astype(np.int64), 0, 255)


def _equalize_lut(hist: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize``'s table: the running count from half a step,
    integer-divided by the step (the count less the top value's, over 255)."""
    present = hist[hist > 0]
    if present.size <= 1:
        return np.arange(256)
    step = (int(present.sum()) - int(present[-1])) // 255
    if not step:
        return np.arange(256)
    return (step // 2 + np.concatenate([[0], np.cumsum(hist)[:-1]])) // step


def _pil_image():
    """PIL's ``Image`` module, imported at the call: the affine transforms
    resample through it (its nearest-neighbour paths for a shift, a
    fixed-point and a float affine map), and its absence is named."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("Rotate, RandomShear and RandomTranslate resample through PIL (Pillow), which is not "
                          "installed") from e
    return Image


@dataclasses.dataclass
class Compose:
    transforms: Sequence

    def __call__(self, sample, rng):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


def _crop_with_padding(arr: np.ndarray, top: int, left: int, height: int, width: int, fill=0):
    """Crop a window that may extend beyond the array; out-of-image regions
    are filled."""
    h, w = arr.shape[:2]
    out = np.full((height, width) + arr.shape[2:], fill, dtype=arr.dtype)
    y0, y1 = max(top, 0), min(top + height, h)
    x0, x1 = max(left, 0), min(left + width, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top : y1 - top, x0 - left : x1 - left] = arr[y0:y1, x0:x1]
    return out


@dataclasses.dataclass
class ContextCrop:
    """Context crop + resize into the target shape:

      * ``ctx`` >= 1 zooms OUT: the crop window is larger than the image
        and the borders become padded, invalid context; ctx < 1 zooms in;
      * the window matches the target aspect, stays (jittered-)centred, and
        is retried with ``ctx *= 0.96`` until >= 50% of the window is real
        pixels and the implied FOV stays under 150 degrees;
      * image resampled bicubic + antialias; depth and validity nearest
        (valid-preserving); the camera is cropped, then uniformly rescaled.
    """

    image_shape: tuple[int, int]
    train_ctx_range: tuple[float, float] = (0.5, 1.5)
    test_context: float = 1.0
    keep_original: bool = False
    test_mode: bool = False
    shape_mult: int = 14
    max_fov_deg: float = 150.0

    def _crop_shapes(self, image_shape, target, ctx):
        h, w = image_shape
        th, tw = target
        input_ratio = w / h
        output_ratio = tw / th
        if output_ratio <= input_ratio:
            if ctx >= 1:
                new_w = w * ctx**0.5
            elif output_ratio / input_ratio * ctx > 1:
                new_w = w * ctx
            else:
                new_w = w * (ctx * output_ratio / input_ratio) ** 0.5
            new_h = new_w / output_ratio
        else:
            if ctx >= 1:
                new_h = h * ctx**0.5
            elif input_ratio / output_ratio * ctx > 1:
                new_h = h * ctx
            else:
                new_h = h * (ctx * input_ratio / output_ratio) ** 0.5
            new_w = new_h * output_ratio
        return int(math.ceil(new_h - 0.5)), int(math.ceil(new_w - 0.5))

    def __call__(self, sample, rng: np.random.Generator, image_shape=None):
        h, w = sample["image"].shape[:2]
        # a per-call shape: the loader samples one a batch, and its worker
        # threads must not mutate shared state
        th, tw = image_shape if image_shape is not None else self.image_shape
        ctx = self.test_context if self.test_mode else float(rng.uniform(*self.train_ctx_range))
        K = sample["K"]
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        max_fov = np.deg2rad(self.max_fov_deg)

        height = width = top = left = 0
        for _ in range(100):
            height, width = self._crop_shapes((h, w), (th, tw), ctx)
            top = (h - height) // 2
            left = (w - width) // 2
            if not self.test_mode:
                jit = self.shape_mult // 2
                left += int(rng.integers(-jit, jit + 1))
                top += int(rng.integers(-jit, jit + 1))
            pad_l = max(-left, 0)
            pad_t = max(-top, 0)
            pad_r = max(left + width - w, 0)
            pad_b = max(top + height - h, 0)
            valid_area = h * w / (h + pad_t + pad_b) / (w + pad_l + pad_r)
            new_hfov = 2.0 * np.arctan(cx / fx * width / w)
            new_vfov = 2.0 * np.arctan(cy / fy * height / h)
            if valid_area >= 0.5 and new_hfov < max_fov and new_vfov < max_fov:
                break
            ctx *= 0.96  # zoom in until enough real pixels and the FOV is ok

        zoom = th / height
        sample["image"] = resize_image(_crop_with_padding(sample["image"], top, left, height, width), (th, tw),
                                       mode="bicubic")
        if "depth" in sample:
            d = _crop_with_padding(sample["depth"], top, left, height, width)
            sample["depth"] = resize_depth(d, (th, tw))
        v = sample.get("validity", np.ones((h, w), bool))
        v = _crop_with_padding(v.astype(np.uint8), top, left, height, width)
        sample["validity"] = resize_depth(v, (th, tw)).astype(bool)
        # optional dense maps: 3-D point maps ride like depth; flow vectors
        # also scale with the zoom (pixel displacements)
        if "points" in sample:
            p = _crop_with_padding(sample["points"], top, left, height, width)
            sample["points"] = resize_nearest_nd(p, (th, tw))
        for fk in ("flow_fwd", "flow_bwd"):
            if fk in sample:
                fl = _crop_with_padding(sample[fk], top, left, height, width)
                sample[fk] = resize_nearest_nd(fl, (th, tw)) * (th / height)
            mk = fk + "_mask"
            if mk in sample:
                m = _crop_with_padding(sample[mk].astype(np.uint8), top, left, height, width)
                sample[mk] = resize_depth(m, (th, tw)).astype(bool)

        K = K.copy()
        K[0, 2] -= left
        K[1, 2] -= top
        K[:2] *= zoom
        sample["K"] = K
        update_camera_params(sample, crop=(left, top, w - (left + width), h - (top + height)), factor=zoom)
        sample["paddings"] = (int(pad_l * zoom), int(pad_r * zoom), int(pad_t * zoom), int(pad_b * zoom))
        return sample


def update_camera_params(sample, *, crop=None, factor=None, flip_w=None):
    """Keep a full camera parameter vector (``camera_params`` of a sample
    whose ``camera_model`` is distorted or panoramic) in step with the
    pipeline's K edits: generic models shift and scale params[:4] as
    CameraBase.crop/resize do; Spherical also tracks W, H, hfov and vfov.

    crop = (left, top, right, bottom) in current pixels; factor = isotropic
    resize factor; flip_w = image width for a horizontal flip.
    """
    cp = sample.get("camera_params")
    if cp is None:
        return
    cp = cp.copy()
    spherical = sample.get("camera_model") == "Spherical"
    if crop is not None:
        left, top, right, bottom = crop
        cp[2] -= left
        cp[3] -= top
        if spherical and cp.shape[0] >= 8:
            W, H = cp[4], cp[5]
            cp[6] *= (W - left - right) / W
            cp[7] *= (H - top - bottom) / H
            cp[4] -= left + right
            cp[5] -= top + bottom
    if factor is not None:
        cp[: 6 if spherical else 4] *= factor
    if flip_w is not None:
        cp[2] = flip_w - cp[2]
        # the x-odd distortion terms flip sign under the mirror (p2, s1, s2
        # of OpenCV / Fisheye624 at 11-13, p2 of MEI at 7)
        model = sample.get("camera_model")
        if model in ("OpenCV", "Fisheye624") and cp.shape[0] >= 14:
            cp[11] = -cp[11]
            cp[12] = -cp[12]
            cp[13] = -cp[13]
        elif model == "MEI" and cp.shape[0] >= 8:
            cp[7] = -cp[7]
    sample["camera_params"] = cp


@dataclasses.dataclass
class RandomFlip:
    prob: float = 0.5

    def __call__(self, sample, rng):
        if rng.random() < self.prob:
            sample["image"] = sample["image"][:, ::-1].copy()
            if "paddings" in sample:
                # the border pads mirror with the image: left <-> right
                pl_, pr_, pt_, pb_ = sample["paddings"]
                sample["paddings"] = (pr_, pl_, pt_, pb_)
            if "depth" in sample:
                sample["depth"] = sample["depth"][:, ::-1].copy()
            if "validity" in sample:
                sample["validity"] = sample["validity"][:, ::-1].copy()
            # dense GT maps ride like depth; flow u (and point-map x) flips
            # sign under a horizontal mirror
            if "points" in sample:
                p = sample["points"][:, ::-1].copy()
                p[..., 0] = -p[..., 0]
                sample["points"] = p
            for fk in ("flow_fwd", "flow_bwd"):
                if fk in sample:
                    fl = sample[fk][:, ::-1].copy()
                    fl[..., 0] = -fl[..., 0]
                    sample[fk] = fl
                if fk + "_mask" in sample:
                    sample[fk + "_mask"] = sample[fk + "_mask"][:, ::-1].copy()
            K = sample["K"].copy()
            K[0, 2] = sample["image"].shape[1] - K[0, 2]
            sample["K"] = K
            update_camera_params(sample, flip_w=sample["image"].shape[1])
            sample["flip"] = not sample.get("flip", False)
        return sample


@dataclasses.dataclass
class RandomColorJitter:
    """PIL's ``ImageEnhance`` Brightness, Contrast and Color in turn, each by
    a factor 1 + U(-strength, strength)."""

    strength: float = 0.4
    prob: float = 0.8

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        img = sample["image"]
        for enhance in ("brightness", "contrast", "color"):
            f = 1.0 + float(rng.uniform(-self.strength, self.strength))
            if enhance == "brightness":
                degenerate = np.zeros((), np.uint8)
            elif enhance == "contrast":
                grey = _grey(img)
                degenerate = np.asarray(int(int(grey.sum(dtype=np.int64)) / grey.size + 0.5), np.uint8)
            else:
                degenerate = _grey(img)[..., None]
            img = _blend(degenerate, img, f)
        sample["image"] = img
        return sample


@dataclasses.dataclass
class RandomGamma:
    strength: float = 0.2
    prob: float = 0.8

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        gamma = 1.0 + float(rng.uniform(-self.strength, self.strength))
        x = sample["image"].astype(np.float32) / 255.0
        sample["image"] = (np.power(x, gamma) * 255.0).clip(0, 255).astype(np.uint8)
        return sample


@dataclasses.dataclass
class GaussianBlur:
    radius: float = 2.0
    prob: float = 0.2

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        r = float(rng.uniform(0.1, self.radius))
        sample["image"] = gaussian_blur(sample["image"], r)
        return sample


@dataclasses.dataclass
class RandomGrayscale:
    prob: float = 0.2

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        sample["image"] = np.repeat(_grey(sample["image"])[..., None], 3, axis=-1)
        return sample


@dataclasses.dataclass
class KittiCrop:
    """Bottom-centre crop to the KITTI benchmark size."""

    crop_size: tuple[int, int] = (352, 1216)

    def __call__(self, sample, rng):
        h, w = sample["image"].shape[:2]
        ch, cw = self.crop_size
        if h < ch or w < cw:
            raise ValueError(f"KittiCrop: image ({h}, {w}) smaller than crop {self.crop_size}")
        top = h - ch
        left = (w - cw) // 2
        sample["image"] = sample["image"][top : top + ch, left : left + cw]
        if "depth" in sample:
            sample["depth"] = sample["depth"][top : top + ch, left : left + cw]
        if "validity" in sample:
            sample["validity"] = sample["validity"][top : top + ch, left : left + cw]
        K = sample["K"].copy()
        K[0, 2] -= left
        K[1, 2] -= top
        sample["K"] = K
        update_camera_params(sample, crop=(left, top, w - (left + cw), h - (top + ch)))
        return sample


_IMAGENET_FILL = (124, 116, 104)  # the image's fill where a rotation or an affine map brings in a border


def _affine_sample(sample, warp):
    """``warp`` (a PIL image -> its rotated or affinely mapped image, nearest
    neighbour) over the image, filled with ``_IMAGENET_FILL``, and over
    depth and validity as float32 "F" images filled with 0, so the borders
    it brings in drop out of the loss."""
    Image = _pil_image()
    sample["image"] = np.asarray(warp(Image.fromarray(sample["image"]), _IMAGENET_FILL))
    for k in ("depth", "validity"):
        if k in sample:
            arr = sample[k]
            sample[k] = np.asarray(warp(Image.fromarray(arr.astype(np.float32)), 0.0)).astype(arr.dtype)
    return sample


@dataclasses.dataclass
class Rotate:
    """Random rotation by +-``angle`` (or a uniform draw from a range),
    nearest neighbour through PIL; sets ``sample["rotation"]``."""

    angle: float | tuple[float, float] = 5.0
    prob: float = 0.5

    def __call__(self, sample, rng):
        if rng.random() > self.prob:
            return sample
        if isinstance(self.angle, (int, float)):
            a = float(rng.choice([-1.0, 1.0])) * self.angle
        else:
            a = float(rng.uniform(self.angle[0], self.angle[1]))
        Image = _pil_image()
        sample = _affine_sample(sample, lambda im, fill: im.rotate(a, resample=Image.NEAREST, fillcolor=fill))
        sample["rotation"] = a
        return sample


@dataclasses.dataclass
class _LevelPhotometric:
    """The standalone photometric transforms: ``level`` is log2 of
    ``ImageEnhance``'s factor, a scalar or a uniform draw from a range."""

    level: float | tuple[float, float] = (-0.5, 0.5)
    prob: float = 0.5

    def _factor(self, rng) -> float:
        if isinstance(self.level, (int, float)):
            return 2.0 ** float(self.level)
        return 2.0 ** float(rng.uniform(self.level[0], self.level[1]))

    def __call__(self, sample, rng):
        if rng.random() > self.prob:
            return sample
        img = sample["image"]
        sample["image"] = _blend(self._degenerate(img), img, self._factor(rng))
        return sample


class RandomSaturation(_LevelPhotometric):
    """``ImageEnhance.Color``: towards or away from the grey image."""

    def _degenerate(self, img):
        return _grey(img)[..., None]


class RandomSharpness(_LevelPhotometric):
    """``ImageEnhance.Sharpness``: towards or away from the SMOOTH-filtered
    image."""

    def _degenerate(self, img):
        return _smooth(img)


class RandomBrightness(_LevelPhotometric):
    """``ImageEnhance.Brightness``: towards or away from black."""

    def _degenerate(self, img):
        return np.zeros((), np.uint8)


class RandomContrast(_LevelPhotometric):
    """``ImageEnhance.Contrast``: towards or away from the grey image's
    mean, rounded."""

    def _degenerate(self, img):
        grey = _grey(img)
        return np.asarray(int(int(grey.sum(dtype=np.int64)) / grey.size + 0.5), np.uint8)


@dataclasses.dataclass
class RandomColor:
    """Random hue rotation by ``level`` of the full cycle, in PIL's HSV
    (the hue shifted by ``int(level * 255)`` modulo 256)."""

    level: float | tuple[float, float] = (-0.05, 0.05)
    prob: float = 0.5

    def __call__(self, sample, rng):
        if rng.random() > self.prob:
            return sample
        if isinstance(self.level, (int, float)):
            f = float(self.level)
        else:
            f = float(rng.uniform(self.level[0], self.level[1]))
        hsv = _rgb_to_hsv(sample["image"])
        hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(f * 255)) % 256
        sample["image"] = _hsv_to_rgb(hsv)
        return sample


@dataclasses.dataclass
class RandomInvert:
    prob: float = 0.5

    def __call__(self, sample, rng):
        if rng.random() > self.prob:
            return sample
        sample["image"] = 255 - sample["image"]
        return sample


@dataclasses.dataclass
class RandomAutoContrast:
    """Per-channel histogram stretch (``ImageOps.autocontrast``)."""

    prob: float = 0.5

    def __call__(self, sample, rng):
        if rng.random() > self.prob:
            return sample
        sample["image"] = _band_luts(sample["image"], _autocontrast_lut)
        return sample


def _magnitude(magnitude, rng) -> float:
    if isinstance(magnitude, (int, float)):
        return float(magnitude) * float(rng.choice([-1.0, 1.0]))
    return float(rng.uniform(magnitude[0], magnitude[1]))


def _affine(coeffs):
    Image = _pil_image()

    def warp(im, fill):
        return im.transform(im.size, Image.AFFINE, coeffs, resample=Image.NEAREST, fillcolor=fill)

    return warp


@dataclasses.dataclass
class RandomShear:
    """Random horizontal or vertical shear by ``magnitude`` (+-a scalar, or
    a uniform draw from a range), nearest neighbour through PIL."""

    magnitude: float | tuple[float, float] = (-0.2, 0.2)
    prob: float = 0.5
    horizontal: bool = True

    def __call__(self, sample, rng):
        if rng.random() > self.prob:
            return sample
        m = _magnitude(self.magnitude, rng)
        coeffs = (1, m, 0, 0, 1, 0) if self.horizontal else (1, 0, 0, m, 1, 0)
        return _affine_sample(sample, _affine(coeffs))


@dataclasses.dataclass
class RandomTranslate:
    """Random shift by ``magnitude`` of the width (or height), truncated to
    whole pixels, through PIL."""

    magnitude: float | tuple[float, float] = (-0.1, 0.1)
    prob: float = 0.5
    horizontal: bool = True

    def __call__(self, sample, rng):
        if rng.random() > self.prob:
            return sample
        m = _magnitude(self.magnitude, rng)
        h, w = sample["image"].shape[:2]
        dx = int(m * w) if self.horizontal else 0
        dy = 0 if self.horizontal else int(m * h)
        return _affine_sample(sample, _affine((1, 0, -dx, 0, 1, -dy)))


@dataclasses.dataclass
class PanoCrop:
    """Trim the polar bands of an equirectangular panorama: drop
    ``crop_v * H`` rows from the top and the bottom and shift the principal
    point with the crop."""

    crop_v: float = 0.1

    def __call__(self, sample, rng):
        h = sample["image"].shape[0]
        t = int(h * self.crop_v)
        for k in ("image", "depth", "validity"):
            if k in sample:
                sample[k] = sample[k][t : h - t]
        K = sample["K"].copy()
        K[1, 2] -= t
        sample["K"] = K
        update_camera_params(sample, crop=(0, t, 0, t))
        return sample


@dataclasses.dataclass
class PanoRoll:
    """Random horizontal roll of a 360-degree panorama, a lossless yaw
    rotation (the camera is unchanged); train time only."""

    roll: tuple[float, float] = (-0.5, 0.5)
    test_mode: bool = False

    def __call__(self, sample, rng):
        if self.test_mode:
            return sample
        w = sample["image"].shape[1]
        r = int(rng.integers(int(w * self.roll[0]), int(w * self.roll[1]) + 1))
        for k in ("image", "depth", "validity"):
            if k in sample:
                sample[k] = np.roll(sample[k], r, axis=1)
        return sample


@dataclasses.dataclass
class AnnotationMask:
    """The depth mask from the depth range and an optional eval crop."""

    min_value: float = 0.0
    max_value: float | None = None
    crop: str | None = None  # None | 'garg' | 'eigen'

    def __call__(self, sample, rng):
        d = sample.get("depth")
        if d is None:
            return sample
        m = d > self.min_value
        if self.max_value is not None:
            m &= d <= self.max_value
        if self.crop is not None:
            h, w = d.shape[:2]
            cm = np.zeros_like(m)
            if self.crop == "garg":
                cm[int(0.40810811 * h) : int(0.99189189 * h), int(0.03594771 * w) : int(0.96405229 * w)] = True
            elif self.crop == "eigen":
                cm[int(0.3324324 * h) : int(0.91351351 * h), int(0.03594771 * w) : int(0.96405229 * w)] = True
            m &= cm
        sample["depth_mask"] = m
        return sample


@dataclasses.dataclass
class Normalize:
    """ImageNet-style normalisation into ``image_norm`` (float32 ``(x / 255
    - mean) / std``); ``image`` stays as it is."""

    mean: tuple[float, float, float]
    std: tuple[float, float, float]

    def __call__(self, sample, rng):
        x = sample["image"].astype(np.float32) / 255.0
        sample["image_norm"] = (x - np.asarray(self.mean, np.float32)) / np.asarray(self.std, np.float32)
        return sample


@dataclasses.dataclass
class RandomSolarize:
    """Values at or above ``threshold`` inverted (``ImageOps.solarize``)."""

    prob: float = 0.1
    threshold: int = 128

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        img = sample["image"]
        sample["image"] = np.where(img < self.threshold, img, 255 - img).astype(np.uint8)
        return sample


@dataclasses.dataclass
class RandomPosterize:
    """The top ``bits`` of each value kept (``ImageOps.posterize``)."""

    prob: float = 0.1
    bits: int = 4

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        sample["image"] = sample["image"] & np.uint8(256 - 2 ** (8 - self.bits))
        return sample


@dataclasses.dataclass
class RandomEqualize:
    """Per-channel histogram equalisation (``ImageOps.equalize``)."""

    prob: float = 0.1

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        sample["image"] = _band_luts(sample["image"], _equalize_lut)
        return sample


@dataclasses.dataclass
class RandomMasking:
    """Zero ``mask_ratio`` of the image's area in random square patches."""

    prob: float = 0.2
    mask_ratio: float = 0.1
    patch: int = 16

    def __call__(self, sample, rng):
        if rng.random() >= self.prob:
            return sample
        img = sample["image"].copy()
        h, w = img.shape[:2]
        n = int(self.mask_ratio * (h * w) / self.patch**2)
        for _ in range(n):
            y = int(rng.integers(0, max(1, h - self.patch)))
            x = int(rng.integers(0, max(1, w - self.patch)))
            img[y : y + self.patch, x : x + self.patch] = 0
        sample["image"] = img
        return sample


@dataclasses.dataclass
class RandomFiller:
    """Fill the image where validity is False with noise, black or white
    (one mode a call, drawn from ``modes``)."""

    modes: tuple[str, ...] = ("noise", "black", "white")

    def __call__(self, sample, rng):
        v = sample.get("validity")
        if v is None or v.all():
            return sample
        img = sample["image"].copy()
        mode = self.modes[int(rng.integers(0, len(self.modes)))]
        inv = ~v
        if mode == "noise":
            img[inv] = rng.integers(0, 255, (int(inv.sum()), 3), dtype=np.uint8)
        elif mode == "white":
            img[inv] = 255
        else:
            img[inv] = 0
        sample["image"] = img
        return sample


def masked_nearest_fill(depth: np.ndarray, mask: np.ndarray, iters: int = 2) -> np.ndarray:
    """Spread valid depth into invalid 4-neighbours ``iters`` times: each
    newly filled pixel takes the mean of its valid neighbours; the
    neighbours wrap around the borders (``np.roll``)."""
    d = depth.copy()
    m = mask.copy()
    for _ in range(iters):
        if m.all():
            break
        acc = np.zeros_like(d)
        cnt = np.zeros_like(d)
        for a in (0, 1):
            for s in (1, -1):
                sm = np.roll(m, s, axis=a)
                acc += np.where(sm, np.roll(d, s, axis=a), 0.0)
                cnt += sm.astype(d.dtype)
        fill = np.divide(acc, np.maximum(cnt, 1), out=np.zeros_like(d))
        new = ~m & (cnt > 0)
        d[new] = fill[new]
        m = m | new
    return d

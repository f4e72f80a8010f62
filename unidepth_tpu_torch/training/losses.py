"""Training losses (counterpart of unidepth_tpu/training/losses.py): fp32,
channel-last, each returning a per-sample vector (B,) that callers weight
and mean.

The JAX package's static-shape redesigns of the reference losses are kept
as they are, so the same inputs give the same values:

* SelfDistill aligns view 0 onto view 1 with one affine bilinear
  grid-sample;
* LocalSSI quantises each level's log-uniform kernel draw to
  ``kernel_buckets`` sizes and picks one per step, with a random roll; the
  draws come from a ``torch.Generator`` here (a CPU one: the kernel size
  is a shape, chosen on the host), so they do not match JAX's bits;
* EdgeGuidedLocalSSI takes the top-k blurred-Sobel cells of the 1/14 grid
  and gathers patches around them (``ops.patches``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from unidepth_tpu_torch.ops.patches import bilinear_sample, extract_patches
from unidepth_tpu_torch.ops.resize import resize

# ---------------------------------------------------------------------------
# input/output transforms and robust penalties
# ---------------------------------------------------------------------------

FNS = {
    "sqrt": lambda x: torch.sqrt(x + 1e-4),
    "log": lambda x: torch.log(x + 1e-4),
    "log1": lambda x: torch.log1p(x),
    "log1i": lambda x: torch.log(1.0 + 50.0 / (1e-4 + x)),
    "linear": lambda x: x,
    "square": torch.square,
    "disp": lambda x: 1.0 / (x + 1e-4),
    "disp1": lambda x: 1.0 / (1.0 + x),
}

REGRESSION_FNS = {
    "l2": lambda e, gamma, alpha: gamma * torch.square(e / gamma),
    "l1": lambda e, gamma, alpha: torch.abs(e),
    "charbonnier": lambda e, gamma, alpha: torch.sqrt(torch.square(e) + gamma**2) - gamma,
    "cauchy": lambda e, gamma, alpha: gamma * torch.log(torch.square(e) / gamma + 1.0),
    "geman_mcclure": lambda e, gamma, alpha: gamma * torch.square(e) / (torch.square(e) + gamma),
    "robust_loss": lambda e, gamma, alpha: gamma
    * (abs(alpha - 2) / alpha)
    * (torch.pow(torch.square(e) / abs(alpha - 2) / gamma**2 + 1.0, alpha / 2) - 1.0),
}


def _dims(axis):
    return axis if isinstance(axis, int) else tuple(axis)


def masked_mean(data, mask, axis, keepdims=True):
    if mask is None:
        return data.mean(dim=_dims(axis), keepdim=keepdims)
    m = mask.to(data.dtype)
    s = m.sum(dim=_dims(axis), keepdim=keepdims)
    return (data * m).sum(dim=_dims(axis), keepdim=keepdims) / s.clamp_min(1.0)


def masked_mean_var(data, mask, axis, keepdims=True):
    dims = _dims(axis)
    if mask is None:
        mean = data.mean(dim=dims, keepdim=True)
        var = torch.square(data - mean).mean(dim=dims, keepdim=keepdims)
        return (mean if keepdims else mean.squeeze(dims)), var
    m = mask.to(data.dtype)
    s = m.sum(dim=dims, keepdim=True).clamp_min(1.0)
    mean = (data * m).sum(dim=dims, keepdim=True) / s
    var = (m * torch.square(data - mean)).sum(dim=dims, keepdim=True) / s
    if not keepdims:
        mean, var = mean.squeeze(dims), var.squeeze(dims)
    return mean, var


def masked_quantile(data, mask, axis: int, q: float):
    """Quantile over ``axis`` of the masked elements (the NaN trick)."""
    filled = data if mask is None else torch.where(mask, data, torch.nan)
    return torch.nanquantile(filled, q, dim=axis)


def masked_median(data, mask, axis: int):
    return masked_quantile(data, mask, axis, 0.5)


def ssi_normalize(input, target, mask, axis=-1):
    """Scale/shift-invariant normalisation stabilised on the 95% interval of
    both (reference losses/utils.py:161-190)."""
    input_d = input.detach()
    in_mean, in_var = masked_mean_var(input_d, mask, axis)
    tg_mean, tg_var = masked_mean_var(target, mask, axis)
    in_std = torch.sqrt(in_var.clamp_min(1e-6))
    tg_std = torch.sqrt(tg_var.clamp_min(1e-6))
    stable = (
        (input_d > in_mean - 1.96 * in_std)
        & (input_d < in_mean + 1.96 * in_std)
        & (target > tg_mean - 1.96 * tg_std)
        & (target < tg_mean + 1.96 * tg_std)
        & mask
    )
    in_mean, in_var = masked_mean_var(input, stable, axis)
    tg_mean, tg_var = masked_mean_var(target, stable, axis)
    input_n = (input - in_mean) / FNS["sqrt"](in_var)
    target_n = (target - tg_mean) / FNS["sqrt"](tg_var)
    return input_n, target_n, stable


def ssi_helper(input, target, mask=None):
    """Closed-form scale and shift aligning ``input`` to ``target`` over all
    axes (reference utils/misc.py:388)."""
    axis = tuple(range(input.ndim))
    in_mean, in_var = masked_mean_var(input, mask, axis)
    tg_mean, tg_var = masked_mean_var(target, mask, axis)
    scale = torch.sqrt(tg_var.clamp_min(1e-6) / in_var.clamp_min(1e-6))
    return scale, tg_mean - scale * in_mean


# ---------------------------------------------------------------------------
# loss modules
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SILog:
    """Scale-invariant log loss with the integrated scale term."""

    weight: float
    input_fn: str = "log"
    output_fn: str = "sqrt"
    integrated: float = 0.15
    name: str = "SILog"

    def __call__(self, input, target, mask, si=None, **kw):
        err = FNS[self.input_fn](input.float()) - FNS[self.input_fn](target.float())
        mean_err, var_err = masked_mean_var(err, mask, axis=(1, 2), keepdims=False)
        if var_err.ndim > 1:
            var_err = var_err.mean(dim=-1)
            mean_err = mean_err.mean(dim=-1)
        if self.integrated > 0.0:
            si_f = torch.zeros_like(var_err) if si is None else si.float()
            var_err = var_err + self.integrated * torch.square(mean_err) * (1.0 - si_f)
        return FNS[self.output_fn](var_err)

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg["weight"], input_fn=cfg.get("input_fn", "log"),
                   output_fn=cfg.get("output_fn", "sqrt"), integrated=cfg.get("integrated", 0.15))


@dataclass(frozen=True)
class Regression:
    """Robust regression: the penalty meaned over channels, then a masked
    mean over the other axes."""

    weight: float
    fn: str = "l2"
    gamma: float = 1.0
    alpha: float = 1.0
    input_fn: str = "linear"
    output_fn: str = "sqrt"
    name: str = "Regression"

    def __call__(self, input, target, mask=None, **kw):
        input = FNS[self.input_fn](input.float())
        target = FNS[self.input_fn](target.float())
        err = REGRESSION_FNS[self.fn](input - target, self.gamma, self.alpha).mean(dim=-1)
        if mask is not None and mask.ndim == err.ndim + 1:
            mask = mask[..., 0]
        out = masked_mean(err, mask, axis=tuple(range(1, err.ndim)), keepdims=False)
        return FNS[self.output_fn](out)

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg["weight"], fn=cfg.get("fn", "l2"), gamma=cfg.get("gamma", 1.0),
                   alpha=cfg.get("alpha", 1.0), input_fn=cfg.get("input_fn", "linear"),
                   output_fn=cfg.get("output_fn", "sqrt"))


@dataclass(frozen=True)
class Confidence:
    """|log-error| regression target for the confidence head, with the
    prediction rescaled by the ratio of the masked medians."""

    weight: float
    input_fn: str = "linear"
    output_fn: str = "sqrt"
    rescale: bool = True
    name: str = "Confidence"

    def __call__(self, input, target_pred, target_gt, mask, **kw):
        b = target_gt.shape[0]
        gt = target_gt.float().reshape(b, -1)
        pred = target_pred.float().reshape(b, -1)
        conf = input.float().reshape(b, -1)
        m = mask.reshape(b, -1)
        if self.rescale:
            ratio = masked_median(gt, m, -1) / masked_median(pred, m, -1).clamp_min(1e-6)
            # an all-False mask row has NaN medians: no rescale for that sample
            ratio = torch.where(torch.isfinite(ratio), ratio, 1.0)
            pred = pred * ratio[:, None]
        err = torch.abs(torch.abs(FNS[self.input_fn](pred) - FNS[self.input_fn](gt)) - conf)
        return FNS[self.output_fn](masked_mean(err, m, axis=-1, keepdims=False))

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg["weight"], input_fn=cfg.get("input_fn", "linear"),
                   output_fn=cfg.get("output_fn", "sqrt"), rescale=cfg.get("rescale", True))


@dataclass(frozen=True)
class SelfDistill:
    """Flip/zoom consistency between the two augmented copies of each image:
    each pixel of view 1 samples view 0 at u0 = fx0 / fx1 (u1 - cx1) + cx0
    (likewise for y), bilinearly with zero padding; the overlap is where
    both views are valid."""

    weight: float
    output_fn: str = "sqrt"
    eps: float = 1e-5
    name: str = "SelfDistill"

    def _align(self, x0, m0, K0, K1, flip_xor, downsample=1.0):
        b, h, w, _ = x0.shape
        fx0, cx0, cy0 = (K0[:, 0, 0] / downsample, K0[:, 0, 2] / downsample, K0[:, 1, 2] / downsample)
        fx1, cx1, cy1 = (K1[:, 0, 0] / downsample, K1[:, 0, 2] / downsample, K1[:, 1, 2] / downsample)
        # flip view 0 horizontally when exactly one of the pair is flipped
        cx0 = torch.where(flip_xor, w - cx0, cx0)
        fx = flip_xor[:, None, None, None]
        x0 = torch.where(fx, x0.flip(2), x0)
        m0 = torch.where(fx, m0.flip(2), m0)
        zoom = fx0 / fx1
        xs = torch.arange(w, dtype=torch.float32, device=x0.device) + 0.5
        ys = torch.arange(h, dtype=torch.float32, device=x0.device) + 0.5
        u0 = zoom[:, None] * (xs[None, :] - cx1[:, None]) + cx0[:, None]
        v0 = zoom[:, None] * (ys[None, :] - cy1[:, None]) + cy0[:, None]
        coords = torch.stack([u0[:, None, :].expand(b, h, w), v0[:, :, None].expand(b, h, w)], dim=-1)
        return bilinear_sample(x0, coords), bilinear_sample(m0.float(), coords) > 0.99

    def __call__(self, input, intrinsics, mask, flips, downsample_ratio=1, **kw):
        """input (B, H, W, C), B = 2 x pairs interleaved; intrinsics (B, 3, 3);
        mask (B, H', W', 1), nearest-resized onto input's grid when it
        differs; flips (B,) bool."""
        if mask.shape[1:3] != input.shape[1:3]:
            m = F.interpolate(mask.float().permute(0, 3, 1, 2), size=tuple(input.shape[1:3]), mode="nearest")
            mask = m.permute(0, 2, 3, 1) > 0.5
        x0, x1 = input[0::2], input[1::2]
        m0, m1 = mask[0::2], mask[1::2]
        K0, K1 = intrinsics[0::2].float(), intrinsics[1::2].float()
        flip_xor = flips[0::2] != flips[1::2]
        x0w, m0w = self._align(x0.float(), m0, K0, K1, flip_xor, float(downsample_ratio))
        overlap = m0w & (m1 > 0)

        def half_loss(a, bb):
            err = torch.square(a - bb.detach()).mean(dim=-1)
            out = masked_mean(err, overlap[..., 0], axis=(1, 2), keepdims=False)
            return FNS[self.output_fn](out + self.eps)

        # re-interleaved, so the (B,) vector follows the input's batch order
        return torch.stack([half_loss(x0w, x1), half_loss(x1, x0w)], dim=1).reshape(-1)

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg["weight"], output_fn=cfg.get("output_fn", "sqrt"))


def _unfold(x, kernel: int, stride: int):
    """(B, H, W, C) -> (B, N, C * k * k) VALID patches, channel-major within
    a patch (``lax.conv_general_dilated_patches``' order)."""
    patches = F.unfold(x.permute(0, 3, 1, 2), kernel_size=kernel, stride=stride)
    return patches.transpose(1, 2)


@dataclass(frozen=True)
class LocalSSI:
    """Multi-scale patchwise scale/shift-invariant loss plus a global term."""

    weight: float
    patch_size: tuple[int, int] = (32, 32)
    min_samples: int = 4
    num_levels: int = 4
    input_fn: str = "linear"
    output_fn: str = "sqrt"
    eps: float = 1e-5
    kernel_buckets: int = 4  # static kernel sizes a level at train time
    name: str = "LocalSSI"

    def _level(self, input, target, mask, k: int, shift: tuple[int, int] | None = None):
        """One pyramid level at kernel size ``k`` -> (B,). ``shift`` (dy,
        dx) rolls the maps first, bringing the unfold's right and bottom
        remainder into a window."""
        stride = max(1, int(k * 0.9))
        if shift is not None:
            input, target, mask = (torch.roll(t, shift, dims=(1, 2)) for t in (input, target, mask))
        pi, pt = _unfold(input, k, stride), _unfold(target, k, stride)
        pm = _unfold(mask.float(), k, stride) > 0.5
        pin, ptn, _ = ssi_normalize(pi, pt, pm, axis=-1)
        err = torch.abs(pin - ptn)
        valid = pm.sum(dim=-1) >= self.min_samples
        err_img = FNS[self.output_fn](masked_mean(err, pm, axis=-1, keepdims=False).clamp_min(self.eps))
        return masked_mean(err_img, valid, axis=-1, keepdims=False)

    def _log_ranges(self) -> list[tuple[float, float]]:
        """Each level's range of log2 kernel sizes."""
        logr = np.linspace(math.log2(min(self.patch_size)), math.log2(max(self.patch_size)), num=self.num_levels + 1)
        return list(zip(logr[:-1], logr[1:]))

    def kernel_sizes(self, h: int, w: int) -> list[list[int]]:
        """Each level's bucket of kernel sizes at an (h, w) map: the
        midpoints of ``kernel_buckets`` slices of the level's log-uniform
        range. ``patch_size`` <= 1 is a fraction of min(h, w), else pixels."""
        return [
            sorted({self._k_of(lo + (i + 0.5) * (hi - lo) / self.kernel_buckets, h, w) for i in range(self.kernel_buckets)})
            for lo, hi in self._log_ranges()
        ]

    def _k_of(self, log_k: float, h: int, w: int) -> int:
        k = 2.0**log_k
        k = int(k * min(h, w)) if max(self.patch_size) <= 1.0 else int(round(k))
        return max(2, min(k, min(h, w)))

    def __call__(self, input, target, mask, rng: torch.Generator | None = None, **kw):
        """``rng``, a CPU generator, draws each level's kernel size from its
        bucket and its roll; without it each level takes its log-mean
        kernel (the evaluation behaviour)."""
        input = FNS[self.input_fn](input.float())
        target = FNS[self.input_fn](target.float())
        b, h, w, _ = input.shape
        total = []
        for (lo, hi), ks in zip(self._log_ranges(), self.kernel_sizes(h, w)):
            if rng is None:
                total.append(self._level(input, target, mask, self._k_of((lo + hi) / 2, h, w)))
                continue
            k = ks[int(torch.randint(len(ks), (), generator=rng))]
            stride = max(1, int(k * 0.9))
            dy = int(torch.randint(-((h - k) % stride), 1, (), generator=rng))
            dx = int(torch.randint(-((w - k) % stride), 1, (), generator=rng))
            total.append(self._level(input, target, mask, k, (dy, dx)))
        gin, gtn, gsm = ssi_normalize(input.reshape(b, -1), target.reshape(b, -1), mask.reshape(b, -1), axis=-1)
        out = masked_mean(torch.abs(gin - gtn), gsm, axis=-1, keepdims=False)
        total.append(FNS[self.output_fn](out.clamp_min(self.eps)))
        return torch.stack(total).mean(dim=0)

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg["weight"], patch_size=tuple(cfg.get("patch_size", (32, 32))),
                   min_samples=cfg.get("min_samples", 4), num_levels=cfg.get("num_levels", 4),
                   input_fn=cfg.get("input_fn", "linear"), output_fn=cfg.get("output_fn", "sqrt"),
                   kernel_buckets=cfg.get("kernel_buckets", 4))


def _sobel_edges(image, validity_mask):
    """RMS Sobel magnitude over channels, zero within 3 pixels of the border
    and where ``validity_mask`` is False."""
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=image.device) / 8.0
    x = image.permute(0, 3, 1, 2)
    c = x.shape[1]

    def grad_rms(k):
        g = F.conv2d(x, k.expand(c, 1, 3, 3).contiguous(), padding=1, groups=c)
        return torch.sqrt(torch.square(g).mean(dim=1, keepdim=True))

    gx, gy = grad_rms(kx), grad_rms(kx.T)
    edges = torch.sqrt(gx * gx + gy * gy).permute(0, 2, 3, 1)
    border = torch.zeros(edges.shape[1:], dtype=torch.bool, device=image.device)
    border[3:-3, 3:-3] = True
    edges = torch.where(border, edges, 0.0)
    if validity_mask is not None:
        edges = torch.where(validity_mask > 0, edges, 0.0)
    return edges


@dataclass(frozen=True)
class EdgeGuidedLocalSSI:
    """V2's edge-sharpness loss: SSI error on patches at the strongest
    image edges (top-k blurred-Sobel cells of the 1/14 grid), plus a global
    term."""

    weight: float
    min_samples: int = 6
    num_patches: int | None = None  # None: 10% of the 1/14-grid cells, at least 10
    center_patches: bool = False  # True: patches centred on the cell, not at its corner
    input_fn: str = "log1i"
    output_fn: str = "sqrt"
    use_global: bool = True
    eps: float = 1e-5
    name: str = "EdgeGuidedLocalSSI"

    def edge_coords(self, image, validity_mask, shape):
        """(B, K, 2) integer (y, x) patch anchors and the odd patch size."""
        b = image.shape[0]
        h, w = shape
        if validity_mask is not None:
            # erosion: the 3x3 sum of the mask is 9
            vm = F.conv2d(validity_mask.float().permute(0, 3, 1, 2), torch.ones(1, 1, 3, 3, device=image.device),
                          padding=1)
            validity_mask = vm.permute(0, 2, 3, 1) >= 9.0 - 1e-3
        edges = _sobel_edges(image.float(), validity_mask)
        gh, gw = max(1, h // 14), max(1, w // 14)
        flat = resize(edges, (gh, gw), mode="bilinear", align_corners=False).reshape(b, -1)
        want = max(10, math.ceil(0.1 * gh * gw)) if self.num_patches is None else self.num_patches
        # the k largest, the lower index first among equals (lax.top_k's
        # order): cells of equal strength, e.g. edgeless ones, are common
        idx = torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, : min(want, flat.shape[-1])]
        offset = 7 if self.center_patches else 0
        coords = torch.stack([idx // gw, idx % gw], dim=-1) * 14 + offset
        ksize = int(0.06 * min(h, w))
        ksize = max(3, ksize + (ksize % 2 == 0))
        return coords, ksize

    def __call__(self, input, target, mask, image, validity_mask=None, rng=None, **kw):
        input = FNS[self.input_fn](input.float())
        target = FNS[self.input_fn](target.float())
        b, h, w, _ = input.shape
        coords, ksize = self.edge_coords(image, validity_mask, (h, w))
        k = coords.shape[1]

        def patches_of(t):
            return extract_patches(t, coords, (ksize, ksize)).reshape(b, k, -1)

        pin, ptn, psm = ssi_normalize(patches_of(input), patches_of(target), patches_of(mask.float()) > 0.5, axis=-1)
        # the patch term means over the stable mask, and counts it for min_samples
        err = torch.abs(pin - ptn).clamp_min(self.eps)
        valid = psm.sum(dim=-1) >= self.min_samples
        err_img = FNS[self.output_fn](masked_mean(err, psm, axis=-1, keepdims=False).clamp_min(self.eps))
        total = [masked_mean(err_img, valid, axis=-1, keepdims=False)]
        if self.use_global:
            gin, gtn, gsm = ssi_normalize(input.reshape(b, -1), target.reshape(b, -1), mask.reshape(b, -1), axis=-1)
            out = masked_mean(torch.abs(gin - gtn).clamp_min(self.eps), gsm, axis=-1, keepdims=False)
            total.append(FNS[self.output_fn](out.clamp_min(self.eps)))
        return torch.stack(total).mean(dim=0)

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg["weight"], min_samples=cfg.get("min_samples", 6), num_patches=cfg.get("num_patches"),
                   center_patches=cfg.get("center_patches", False), input_fn=cfg.get("input_fn", "log1i"),
                   output_fn=cfg.get("output_fn", "sqrt"), use_global=cfg.get("use_global", True))


@dataclass(frozen=True)
class ARel:
    """Relative L1."""

    weight: float
    input_fn: str = "linear"
    output_fn: str = "sqrt"
    name: str = "ARel"

    def __call__(self, input, target, mask, **kw):
        input = FNS[self.input_fn](input.float())
        target = FNS[self.input_fn](target.float())
        err = torch.abs(input - target) / target.clamp_min(1e-6)
        return FNS[self.output_fn](masked_mean(err, mask, axis=(1, 2, 3), keepdims=False))

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg["weight"], input_fn=cfg.get("input_fn", "linear"), output_fn=cfg.get("output_fn", "sqrt"))


@dataclass(frozen=True)
class Dummy:
    weight: float = 0.0
    name: str = "Dummy"

    def __call__(self, input, *a, **kw):
        return torch.zeros(input.shape[0], dtype=torch.float32, device=input.device)

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg.get("weight", 0.0))


@dataclass(frozen=True)
class TeacherDistill:
    """Feature distillation against a teacher (no shipped config wires it)."""

    weight: float
    output_fn: str = "sqrt"
    eps: float = 1e-5
    name: str = "TeacherDistill"

    def __call__(self, student_feats, teacher_feats, mask=None, **kw):
        err = torch.square(student_feats.float() - teacher_feats.float().detach()).mean(dim=-1)
        out = masked_mean(err, mask, axis=tuple(range(1, err.ndim)), keepdims=False)
        return FNS[self.output_fn](out + self.eps)

    @classmethod
    def build(cls, cfg):
        return cls(weight=cfg["weight"], output_fn=cfg.get("output_fn", "sqrt"))


LOSS_REGISTRY = {
    "SILog": SILog,
    "Regression": Regression,
    "Confidence": Confidence,
    "SelfDistill": SelfDistill,
    "LocalSSI": LocalSSI,
    "EdgeGuidedLocalSSI": EdgeGuidedLocalSSI,
    "ARel": ARel,
    "Dummy": Dummy,
    "TeacherDistill": TeacherDistill,
}


def build_losses(config: dict) -> dict:
    """Config -> {slot name: loss}."""
    return {slot: LOSS_REGISTRY[cfg["name"]].build(cfg) for slot, cfg in config["training"]["losses"].items()}

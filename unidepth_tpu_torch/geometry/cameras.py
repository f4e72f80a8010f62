"""The generalized camera library (counterpart of
unidepth_tpu/geometry/cameras.py).

A camera holds a ``(B, P)`` float32 ``params`` tensor on its device, with
``params[..., :4] = (fx, fy, cx, cy)`` for every family; ``crop``,
``resize``, ``flip`` and ``to`` return new cameras and never write the
caller's tensor. Pixel coordinates are centres at +0.5; rays and points
are channel-last ``(B, H, W, 3)``. The iterative unprojections of the
distortion models run a fixed count of Newton steps, as in JAX.

``BatchCamera`` carries a mixed batch: params padded to 16 columns and a
type id a sample into ``_CAMERA_TYPES`` (the JAX order, so ids mean the same
in both packages). Geometry groups the samples by type, runs each class on
its rows and scatters the results back; the per-type ``crop``, ``resize``,
``flip``, ``hfov`` and ``vfov`` are computed for every type and selected by
id on the device.
"""

from __future__ import annotations

import torch

from unidepth_tpu_torch.geometry.coords import coords_grid

__all__ = ["CAMERA_TYPE_IDS", "BatchCamera", "CameraBase", "EUCM", "Fisheye624", "MEI", "OpenCV", "Pinhole",
           "Spherical"]


def _norm(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return n if eps == 0.0 else n.clamp_min(eps)


def _sign_clamp(x: torch.Tensor, eps: float) -> torch.Tensor:
    """|x| >= eps, keeping the sign (0 goes to +eps)."""
    return torch.where(x.abs() < eps, torch.where(x < 0, -eps, eps), x)


def _cols(params: torch.Tensor, n: int):
    """The first ``n`` parameter columns, each (B, 1, 1) against (B, H, W)."""
    return tuple(params[:, None, None, i] for i in range(n))


class CameraBase:
    """Shared affine behaviour over (fx, fy, cx, cy) = params[..., :4]."""

    # distortion coefficients that flip sign under a mirror: x -> -x negates
    # the x-even tangential and thin-prism terms, y -> -y the y-even ones
    _FLIP_NEGATE_H: tuple[int, ...] = ()
    _FLIP_NEGATE_V: tuple[int, ...] = ()

    def __init__(self, params: torch.Tensor):
        self.params = params

    def replace(self, params: torch.Tensor) -> "CameraBase":
        return type(self)(params)

    @property
    def batch(self) -> int:
        return self.params.shape[0]

    def to(self, device) -> "CameraBase":
        return self.replace(self.params.to(device=device, dtype=torch.float32))

    def expand(self, batch: int) -> "CameraBase":
        """Broadcast a one-camera batch to ``batch`` cameras."""
        return self.replace(self.params.expand(batch, self.params.shape[1]))

    # ---- intrinsics matrix ------------------------------------------------
    @property
    def K(self) -> torch.Tensor:
        fx, fy, cx, cy = self.params[..., :4].unbind(-1)
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([fx, z, cx], -1), torch.stack([z, fy, cy], -1), torch.stack([z, z, o], -1)], -2)

    @property
    def K_inv(self) -> torch.Tensor:
        fx, fy, cx, cy = self.params[..., :4].unbind(-1)
        z, o = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([torch.stack([1.0 / fx, z, -cx / fx], -1), torch.stack([z, 1.0 / fy, -cy / fy], -1),
                            torch.stack([z, z, o], -1)], -2)

    # ---- affine re-parameterisations ---------------------------------------
    def crop(self, left, top, right=None, bottom=None) -> "CameraBase":
        """Shift the principal point; negative values express padding."""
        p = self.params.clone()
        p[..., 2] -= left
        p[..., 3] -= top
        return self.replace(p)

    def resize(self, factor) -> "CameraBase":
        p = self.params.clone()
        p[..., :4] *= factor
        return self.replace(p)

    def flip(self, H, W, direction: str = "horizontal") -> "CameraBase":
        p = self.params.clone()
        if direction == "horizontal":
            p[..., 2] = W - p[..., 2]
            negate = self._FLIP_NEGATE_H
        else:
            p[..., 3] = H - p[..., 3]
            negate = self._FLIP_NEGATE_V
        for i in negate:
            p[..., i] = -p[..., i]
        return self.replace(p)

    @property
    def hfov(self) -> torch.Tensor:
        return 2.0 * torch.atan(self.params[..., 2] / self.params[..., 0])

    @property
    def vfov(self) -> torch.Tensor:
        return 2.0 * torch.atan(self.params[..., 3] / self.params[..., 1])

    def get_new_fov(self, new_shape, original_shape):
        """(hfov, vfov) of the pinhole part once the image goes from
        ``original_shape`` to ``new_shape`` at the same intrinsics."""
        p = self.params
        new_hfov = 2.0 * torch.atan(p[..., 2] / p[..., 0] * new_shape[1] / original_shape[1])
        new_vfov = 2.0 * torch.atan(p[..., 3] / p[..., 1] * new_shape[0] / original_shape[0])
        return new_hfov, new_vfov

    # ---- geometry ------------------------------------------------------------
    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def project(self, xyz: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _grid(self, b: int, h: int, w: int) -> torch.Tensor:
        return coords_grid(h, w, device=self.params.device).expand(b, h, w, 2)

    def get_rays(self, h: int, w: int, eps: float = 1e-4) -> torch.Tensor:
        """Unit ray directions (B, H, W, 3)."""
        rays = self.unproject(self._grid(self.batch, h, w))
        return rays / _norm(rays, eps)

    def get_pinhole_rays(self, h: int, w: int, eps: float = 1e-4) -> torch.Tensor:
        """Unit rays through the pinhole part of K only: they differ from
        ``get_rays`` for the distorted models."""
        uv = self._grid(self.batch, h, w)
        uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
        rays = torch.einsum("bij,bhwj->bhwi", self.K_inv, uv1)
        return rays / _norm(rays, eps)

    def reconstruct(self, depth: torch.Tensor) -> torch.Tensor:
        """depth (B, H, W, 1) -> points (B, H, W, 3); z-depth for the
        perspective families."""
        b, h, w, _ = depth.shape
        rays = self.unproject(self._grid(b, h, w))
        rays = rays / rays[..., 2:3].clamp_min(1e-4)
        return rays * depth.clamp_min(1e-4)

    def mask_overlap_projection(self, projected: torch.Tensor) -> torch.Tensor:
        """Occlusion / fold-over mask of a projected flow field (B, H, W, 2):
        sample the flow a small step along itself; pixels whose flow shrinks
        are overlaps."""
        from unidepth_tpu_torch.ops.patches import bilinear_sample

        b, h, w, _ = projected.shape
        idc = self._grid(b, h, w)
        flow = projected - idc
        gamma = 0.1
        sampled = bilinear_sample(flow, gamma * flow + idc, zero_pad=False)
        fn, sn = _norm(flow), _norm(sampled)
        return ((1.0 - gamma) * fn < sn) | (fn < 1.0)


class Pinhole(CameraBase):
    """Perspective camera; params (fx, fy, cx, cy)."""

    @classmethod
    def from_K(cls, K: torch.Tensor) -> "Pinhole":
        """K: (3, 3) or (B, 3, 3) intrinsics matrix."""
        if K.ndim == 2:
            K = K[None]
        return cls(torch.stack([K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]], dim=-1).float())

    def unproject(self, uv):
        fx, fy, cx, cy = _cols(self.params, 4)
        x = (uv[..., 0] - cx) / fx
        y = (uv[..., 1] - cy) / fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def project(self, xyz):
        fx, fy, cx, cy = _cols(self.params, 4)
        z = xyz[..., 2].clamp_min(0.01)
        return torch.stack([fx * xyz[..., 0] / z + cx, fy * xyz[..., 1] / z + cy], dim=-1)

    def reconstruct(self, depth):
        b, h, w, _ = depth.shape
        return self.unproject(self._grid(b, h, w)) * depth.clamp_min(0.0)


class EUCM(CameraBase):
    """Enhanced unified camera model; params (fx, fy, cx, cy, alpha, beta)."""

    def unproject(self, uv):
        fx, fy, cx, cy, alpha, beta = _cols(self.params, 6)
        mx = (uv[..., 0] - cx) / fx
        my = (uv[..., 1] - cy) / fy
        r2 = mx * mx + my * my
        sqrt_val = 1.0 - (2.0 * alpha - 1.0) * beta * r2
        mz = (1.0 - beta * alpha * alpha * r2) / (alpha * torch.sqrt(sqrt_val.clamp_min(1e-5)) + (1.0 - alpha))
        coeff = 1.0 / torch.sqrt(mx * mx + my * my + mz * mz + 1e-5)
        return torch.stack([coeff * mx, coeff * my, (coeff * mz).clamp_min(1e-3)], dim=-1)

    def project(self, xyz):
        fx, fy, cx, cy, alpha, beta = _cols(self.params, 6)
        x, y, z = xyz.unbind(-1)
        d = torch.sqrt(beta * (x * x + y * y) + z * z)
        den = (alpha * d + (1.0 - alpha) * z).clamp_min(1e-3)
        return torch.stack([fx * x / den + cx, fy * y / den + cy], dim=-1)


class Spherical(CameraBase):
    """Equirectangular panorama; params (fx, fy, cx, cy, W, H, hfov/2,
    vfov/2), angles in radians. Its ``resize`` scales W and H too, and its
    ``crop`` narrows the field of view."""

    def resize(self, factor):
        p = self.params.clone()
        p[..., :6] *= factor
        return self.replace(p)

    def crop(self, left, top, right=None, bottom=None):
        right = 0 if right is None else right
        bottom = 0 if bottom is None else bottom
        p = self.params.clone()
        W, H = self.params[..., 4], self.params[..., 5]
        p[..., 2] -= left
        p[..., 3] -= top
        p[..., 6] *= (W - left - right) / W
        p[..., 7] *= (H - top - bottom) / H
        p[..., 4] -= left + right
        p[..., 5] -= top + bottom
        return self.replace(p)

    def _angles(self):
        W, H, half_h, half_v = _cols(self.params[:, 4:8], 4)
        return W, H, 2.0 * half_h, 2.0 * half_v

    def unproject(self, uv):
        W, H, hfov, vfov = self._angles()
        # the reference's (W - 1) denominators, kept with pixel-centre uv:
        # project and unproject stay each other's inverse
        lon = (uv[..., 0] - (W - 1) / 2.0) / (W - 1) * hfov
        lat = (uv[..., 1] - (H - 1) / 2.0) / (H - 1) * vfov
        v = torch.stack([torch.cos(lat) * torch.sin(lon), torch.sin(lat), torch.cos(lat) * torch.cos(lon)], dim=-1)
        return v / _norm(v, 1e-5)

    def project(self, xyz):
        W, H, hfov, vfov = self._angles()
        lon = torch.atan2(xyz[..., 0], xyz[..., 2])
        lat = torch.asin((xyz[..., 1] / _norm(xyz)[..., 0].clamp_min(1e-5)).clamp(-1.0, 1.0))
        return torch.stack([lon / hfov * (W - 1) + (W - 1) / 2.0, lat / vfov * (H - 1) + (H - 1) / 2.0], dim=-1)

    def reconstruct(self, depth):
        """Spherical depth is radial."""
        b, h, w, _ = depth.shape
        return self.unproject(self._grid(b, h, w)) * depth

    @property
    def hfov(self):
        return 2.0 * self.params[..., 6]

    @property
    def vfov(self):
        return 2.0 * self.params[..., 7]


def _newton_unproject(distort_fn, mx, my, params, iters: int):
    """Invert (x, y) -> distort_fn(x, y) = (mx, my) with ``iters`` Newton
    steps on a numeric 2x2 Jacobian (forward differences, step 1e-4)."""
    x, y = mx, my
    eps = 1e-4
    for _ in range(iters):
        fxv, fyv = distort_fn(x, y, params)
        rx, ry = fxv - mx, fyv - my
        fx_dx, fy_dx = distort_fn(x + eps, y, params)
        fx_dy, fy_dy = distort_fn(x, y + eps, params)
        j11, j21 = (fx_dx - fxv) / eps, (fy_dx - fyv) / eps
        j12, j22 = (fx_dy - fxv) / eps, (fy_dy - fyv) / eps
        # |det| >= 1e-12 with its sign kept: sign(det) * 1e-12 + 1e-12 maps a
        # tiny negative det to exactly 0, and the division to inf / NaN
        det = _sign_clamp(j11 * j22 - j12 * j21, 1e-12)
        x, y = x - (rx * j22 - ry * j12) / det, y - (ry * j11 - rx * j21) / det
    return x, y


class _NewtonCamera(CameraBase):
    """A model unprojected by Newton steps on the normalised plane."""

    iters = 10

    @staticmethod
    def _distort(x, y, p):
        raise NotImplementedError

    def _unit_plane(self, uv):
        p = self.params[:, None, None, :]
        mx = (uv[..., 0] - p[..., 2]) / p[..., 0]
        my = (uv[..., 1] - p[..., 3]) / p[..., 1]
        return _newton_unproject(self._distort, mx, my, p, self.iters)

    def unproject(self, uv):
        x, y = self._unit_plane(uv)
        v = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return v / _norm(v, 1e-5)

    def project(self, xyz):
        p = self.params[:, None, None, :]
        # a sign-preserving guard: rear-hemisphere points mirror, as in the
        # reference, instead of exploding through a positive clamp
        z = _sign_clamp(xyz[..., 2], 1e-3)
        xd, yd = self._distort(xyz[..., 0] / z, xyz[..., 1] / z, p)
        return torch.stack([p[..., 0] * xd + p[..., 2], p[..., 1] * yd + p[..., 3]], dim=-1)


def _tangential_prism(x, y, p):
    """The tangential (p1, p2 = params 10, 11) and thin-prism (s1..s4 =
    12..15) terms of the OpenCV and Fisheye624 models."""
    p1, p2, s1, s2, s3, s4 = (p[..., i] for i in range(10, 16))
    r2 = x * x + y * y
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r2 * r2
    dy = 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y) + s3 * r2 + s4 * r2 * r2
    return dx, dy


class OpenCV(_NewtonCamera):
    """OpenCV radial / tangential / thin-prism model; params (fx, fy, cx,
    cy, k1..k6, p1, p2, s1..s4), 16 in all (k4..k6 unused, as in the
    reference). 10 Newton steps."""

    _FLIP_NEGATE_H = (11, 12, 13)  # p2, s1, s2
    _FLIP_NEGATE_V = (10, 14, 15)  # p1, s3, s4

    @staticmethod
    def _distort(x, y, p):
        k1, k2, k3 = p[..., 4], p[..., 5], p[..., 6]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx, dy = _tangential_prism(x, y, p)
        return x * radial + dx, y * radial + dy


class Fisheye624(_NewtonCamera):
    """Fisheye624 (6 radial, 2 tangential, 4 thin-prism) over the angle of
    incidence theta; params (fx, fy, cx, cy, k1..k6, p1, p2, s1..s4). 10
    Newton steps."""

    _FLIP_NEGATE_H = (11, 12, 13)  # p2, s1, s2
    _FLIP_NEGATE_V = (10, 14, 15)  # p1, s3, s4

    @staticmethod
    def _distort(ux, uy, p):
        r = torch.sqrt(ux * ux + uy * uy)
        theta = torch.atan(r)
        # r(theta) = theta (1 + k1 th^2 + ... + k6 th^12), Horner form
        th2 = theta * theta
        acc = p[..., 9]
        for i in (8, 7, 6, 5, 4):
            acc = acc * th2 + p[..., i]
        rd = theta * (1.0 + th2 * acc)
        scale = torch.where(r > 1e-8, rd / r.clamp_min(1e-8), 1.0)
        xr, yr = ux * scale, uy * scale
        dx, dy = _tangential_prism(xr, yr, p)
        return xr + dx, yr + dy


class MEI(_NewtonCamera):
    """Unified (Mei) omnidirectional model with radial / tangential
    distortion; params (fx, fy, cx, cy, k1, k2, p1, p2, xi). 20 Newton
    steps."""

    _FLIP_NEGATE_H = (7,)  # p2
    _FLIP_NEGATE_V = (6,)  # p1
    iters = 20

    @staticmethod
    def _distort(x, y, p):
        k1, k2, p1, p2 = p[..., 4], p[..., 5], p[..., 6], p[..., 7]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * k2)
        return (x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x),
                y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y))

    def unproject(self, uv):
        x, y = self._unit_plane(uv)
        xi = self.params[:, None, None, 8]
        # lift from the unified sphere: (x, y) are mu coordinates
        r2 = x * x + y * y
        factor = (xi + torch.sqrt((1.0 + (1.0 - xi * xi) * r2).clamp_min(0.0))) / (1.0 + r2)
        v = torch.stack([factor * x, factor * y, factor - xi], dim=-1)
        return v / _norm(v, 1e-5)

    def project(self, xyz):
        p = self.params[:, None, None, :]
        z = (xyz[..., 2] + p[..., 8] * _norm(xyz)[..., 0].clamp_min(1e-5)).clamp_min(1e-5)
        xd, yd = self._distort(xyz[..., 0] / z, xyz[..., 1] / z, p)
        return torch.stack([p[..., 0] * xd + p[..., 2], p[..., 1] * yd + p[..., 3]], dim=-1)


_CAMERA_TYPES = [Pinhole, EUCM, Spherical, OpenCV, Fisheye624, MEI]
CAMERA_TYPE_IDS = {cls.__name__: i for i, cls in enumerate(_CAMERA_TYPES)}  # name -> BatchCamera type id


class BatchCamera(CameraBase):
    """A mixed batch: params (B, 16), zero-padded, and ``type_ids`` (B,)
    int64 into ``_CAMERA_TYPES`` on the same device."""

    def __init__(self, params: torch.Tensor, type_ids: torch.Tensor):
        super().__init__(params)
        self.type_ids = type_ids

    def replace(self, params: torch.Tensor) -> "BatchCamera":
        return BatchCamera(params, self.type_ids)

    def to(self, device) -> "BatchCamera":
        return BatchCamera(self.params.to(device=device, dtype=torch.float32), self.type_ids.to(device))

    def expand(self, batch: int) -> "BatchCamera":
        return BatchCamera(self.params.expand(batch, self.params.shape[1]), self.type_ids.expand(batch))

    @classmethod
    def from_camera(cls, camera: CameraBase) -> "BatchCamera":
        if isinstance(camera, BatchCamera):
            return camera
        b, p = camera.params.shape
        params = torch.nn.functional.pad(camera.params, (0, 16 - p))
        tid = CAMERA_TYPE_IDS[type(camera).__name__]
        return cls(params, torch.full((b,), tid, dtype=torch.int64, device=params.device))

    @classmethod
    def concat(cls, cameras: list[CameraBase]) -> "BatchCamera":
        batched = [cls.from_camera(c) for c in cameras]
        return cls(torch.cat([b.params for b in batched]), torch.cat([b.type_ids for b in batched]))

    def _dispatch(self, method: str, arg: torch.Tensor) -> torch.Tensor:
        """Run ``method`` of each type on its samples' rows and scatter the
        results back: one small copy of the type ids to the host a call,
        none a sample."""
        ids = self.type_ids.tolist()
        out = None
        for tid in sorted(set(ids)):
            rows = torch.tensor([i for i, t in enumerate(ids) if t == tid], device=arg.device)
            res = getattr(_CAMERA_TYPES[tid](self.params[rows]), method)(arg[rows])
            if out is None:
                out = res.new_empty((len(ids), *res.shape[1:]))
            out[rows] = res
        return out

    def unproject(self, uv):
        return self._dispatch("unproject", uv)

    def project(self, xyz):
        return self._dispatch("project", xyz)

    def reconstruct(self, depth):
        return self._dispatch("reconstruct", depth)

    # crop / resize / flip differ by type (Spherical rescales W, H and its
    # angles), and the base's pinhole update would corrupt a Spherical
    # member: every type's update is computed and selected by type id
    def _affine_select(self, method: str, *args, **kwargs) -> "BatchCamera":
        variants = torch.stack([getattr(cls(self.params), method)(*args, **kwargs).params for cls in _CAMERA_TYPES])
        rows = torch.arange(self.batch, device=self.params.device)
        return self.replace(variants[self.type_ids, rows])

    def crop(self, left, top, right=None, bottom=None):
        return self._affine_select("crop", left, top, right, bottom)

    def resize(self, factor):
        return self._affine_select("resize", factor)

    def flip(self, H, W, direction="horizontal"):
        return self._affine_select("flip", H, W, direction=direction)

    def _property_select(self, name: str) -> torch.Tensor:
        vals = torch.stack([getattr(cls(self.params), name) for cls in _CAMERA_TYPES])  # (T, B)
        return vals[self.type_ids, torch.arange(self.batch, device=self.params.device)]

    @property
    def hfov(self):
        return self._property_select("hfov")

    @property
    def vfov(self):
        return self._property_select("vfov")

"""The port's camera library against the JAX package's on shared seeded
parameters (fp32, CPU).

Each of the six families at B = 2: K, K_inv, hfov, vfov, the fov after a
resize, crop / resize / flip, unproject, get_rays, get_pinhole_rays,
project of shared points, reconstruct, mask_overlap_projection. Gates: the
closed-form families at atol 1e-5 on unit rays and rtol 1e-5 elsewhere;
the Newton families (OpenCV, Fisheye624, MEI) at atol 1e-4 on unit-plane
rays (points from ``reconstruct`` at 5e-4: that times a depth up to 5),
since their 1e-4 forward-difference Jacobian makes each step's rounding
differ between the two packages' float32 op orders. A mixed
``BatchCamera`` holding all six types (and one holding Spherical with
Pinhole): its dispatch and its per-type affine select against JAX and
against its members run one type at a time. The Newton determinant clamp at
a tiny negative determinant stays finite, as JAX's does. The converter's
``from_jax_camera`` and ``collate`` of a mixed batch close the file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.datasets.loader import collate as j_collate
from unidepth_tpu.geometry import cameras as jcam
from unidepth_tpu.geometry.coords import coords_grid as j_coords_grid
from unidepth_tpu_torch.datasets.loader import collate
from unidepth_tpu_torch.geometry import cameras as tcam
from unidepth_tpu_torch.geometry.cameras import _newton_unproject
from unidepth_tpu_torch.io.convert import from_jax_camera

H, W = 24, 32
PARAMS = {
    "Pinhole": [[30.0, 31.0, 16.0, 12.0], [28.0, 29.0, 15.0, 13.0]],
    "EUCM": [[30.0, 30.0, 16.0, 12.0, 0.5, 1.0], [29.0, 29.5, 15.5, 12.5, 0.6, 1.1]],
    "Spherical": [[6.4, 6.4, 16.0, 12.0, 32.0, 24.0, np.pi, np.pi / 2],
                  [6.0, 6.0, 15.0, 11.0, 30.0, 22.0, 0.8 * np.pi, 0.4 * np.pi]],
    "OpenCV": [[30.0, 30.0, 16.0, 12.0, 0.05, -0.01, 0.001, 0, 0, 0, 0.01, -0.005, 0.002, 0, -0.001, 0],
               [31.0, 30.0, 15.0, 12.5, -0.03, 0.02, 0.0, 0, 0, 0, -0.004, 0.006, 0, 0.001, 0, 0.002]],
    "Fisheye624": [[30.0, 30.0, 16.0, 12.0, 0.1, -0.02, 0.003, 0, 0, 0, 0.001, -0.002, 0.001, 0, 0, 0],
                   [29.0, 29.0, 16.5, 11.5, 0.08, -0.01, 0, 0.001, 0, 0, 0, 0.001, 0, 0.001, 0.002, 0]],
    "MEI": [[30.0, 30.0, 16.0, 12.0, 0.05, -0.01, 0.001, 0.0, 0.4], [28.0, 29.0, 15.0, 12.5, -0.02, 0.01, 0.0, 0.002, 0.8]],
}
NEWTON = ("OpenCV", "Fisheye624", "MEI")
NAMES = list(PARAMS)


def _pair(name, rows=slice(None)):
    p = np.asarray(PARAMS[name], np.float32)[rows]
    return getattr(jcam, name)(params=jnp.asarray(p)), getattr(tcam, name)(torch.from_numpy(p))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _ray_tol(name):
    return dict(atol=1e-4) if name in NEWTON else dict(atol=1e-5)


def _points(b, seed=0):
    """Seeded points in front of the camera, (B, H, W, 3)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.4, 0.4, (b, H, W, 3)).astype(np.float32)
    xyz[..., 2] = rng.uniform(1.0, 3.0, (b, H, W))
    return xyz


@pytest.mark.parametrize("name", NAMES)
def test_intrinsics_and_affine_updates_match_jax(name):
    jc, tc = _pair(name)
    _close(tc.K, jc.K, rtol=1e-6)
    _close(tc.K_inv, jc.K_inv, rtol=1e-6)
    _close(tc.hfov, jc.hfov, rtol=1e-6)
    _close(tc.vfov, jc.vfov, rtol=1e-6)
    for t, j in zip(tc.get_new_fov((12, 20), (H, W)), jc.get_new_fov((12, 20), (H, W))):
        _close(t, j, rtol=1e-6)
    _close(tc.crop(-3, -5).resize(2.0).params, jc.crop(-3, -5).resize(2.0).params, rtol=1e-6)
    _close(tc.crop(4.0, 2.0, 3.0, 1.0).params, jc.crop(4.0, 2.0, 3.0, 1.0).params, rtol=1e-6)
    for direction in ("horizontal", "vertical"):
        _close(tc.flip(H, W, direction).params, jc.flip(H, W, direction).params, rtol=1e-6)
    before = tc.params.clone()
    tc.crop(1, 2).resize(0.5).flip(H, W)
    assert torch.equal(tc.params, before)  # no update writes the caller's tensor


@pytest.mark.parametrize("name", NAMES)
def test_geometry_matches_jax(name):
    jc, tc = _pair(name)
    uv = np.array(j_coords_grid(H, W))[None].repeat(2, 0)
    _close(tc.unproject(torch.from_numpy(uv)), jc.unproject(jnp.asarray(uv)), **_ray_tol(name))
    _close(tc.get_rays(H, W), jc.get_rays(H, W), **_ray_tol(name))
    _close(tc.get_pinhole_rays(H, W), jc.get_pinhole_rays(H, W), atol=1e-6)
    xyz = _points(2)
    _close(tc.project(torch.from_numpy(xyz)), jc.project(jnp.asarray(xyz)), rtol=1e-5, atol=1e-4)
    depth = np.random.default_rng(1).uniform(0.5, 5.0, (2, H, W, 1)).astype(np.float32)
    _close(tc.reconstruct(torch.from_numpy(depth)), jc.reconstruct(jnp.asarray(depth)),
           atol=5e-4 if name in NEWTON else 1e-5, rtol=1e-4)
    flow = uv + np.random.default_rng(2).normal(0, 1.5, (2, H, W, 2)).astype(np.float32)
    assert torch.equal(tc.mask_overlap_projection(torch.from_numpy(flow)),
                       torch.from_numpy(np.asarray(jc.mask_overlap_projection(jnp.asarray(flow)))))


@pytest.mark.parametrize("name", NAMES)
def test_project_inverts_unproject(name):
    """project(unproject(uv)) returns the pixel centres (the interior, where
    the distortion models invert well), in the port alone."""
    _, tc = _pair(name)
    uv = torch.from_numpy(np.array(j_coords_grid(H, W)))[None].expand(2, H, W, 2)
    back = tc.project(tc.unproject(uv) * 2.5)
    torch.testing.assert_close(back[:, 4:-4, 4:-4], uv[:, 4:-4, 4:-4], rtol=0, atol=2e-3)


def _mixed(names):
    return ([_pair(n, slice(0, 1))[0] for n in names], [_pair(n, slice(0, 1))[1] for n in names])


def test_batch_camera_dispatch_matches_jax_and_its_members():
    names = ["MEI", "Pinhole", "Spherical", "Fisheye624", "EUCM", "OpenCV", "Pinhole"]
    jcams, tcams = _mixed(names)
    jb, tb = jcam.BatchCamera.concat(jcams), tcam.BatchCamera.concat(tcams)
    assert tb.params.shape == (7, 16)
    assert tb.type_ids.tolist() == np.asarray(jb.type_ids).tolist() == [tcam.CAMERA_TYPE_IDS[n] for n in names]
    newton = torch.tensor([n in NEWTON for n in names])
    rays = tb.get_rays(H, W)
    ref = torch.from_numpy(np.asarray(jb.get_rays(H, W)))
    torch.testing.assert_close(rays[~newton], ref[~newton], rtol=0, atol=1e-5)
    torch.testing.assert_close(rays[newton], ref[newton], rtol=0, atol=1e-4)
    xyz = _points(len(names), seed=3)
    _close(tb.project(torch.from_numpy(xyz)), jb.project(jnp.asarray(xyz)), rtol=1e-5, atol=1e-4)
    depth = np.random.default_rng(4).uniform(0.5, 5.0, (len(names), H, W, 1)).astype(np.float32)
    _close(tb.reconstruct(torch.from_numpy(depth)), jb.reconstruct(jnp.asarray(depth)), rtol=1e-4, atol=5e-4)
    for i, cam in enumerate(tcams):  # each member on its own, bit for bit
        assert torch.equal(rays[i], cam.get_rays(H, W)[0])
        assert torch.equal(tb.project(torch.from_numpy(xyz))[i], cam.project(torch.from_numpy(xyz[i : i + 1]))[0])


@pytest.mark.parametrize("names", [["Pinhole", "Spherical"], NAMES])
def test_batch_camera_affine_select_matches_jax(names):
    """A Spherical member takes its own crop and resize (W, H and its
    angles), not the pinhole update, in the port as in JAX."""
    jcams, tcams = _mixed(names)
    jb, tb = jcam.BatchCamera.concat(jcams), tcam.BatchCamera.concat(tcams)
    for op, args, kwargs in (("crop", (-3.0, -5.0), {}), ("crop", (10.0, 6.0, 4.0, 2.0), {}), ("resize", (0.5,), {}),
                             ("flip", (H, W), {}), ("flip", (H, W), {"direction": "vertical"})):
        got = getattr(tb, op)(*args, **kwargs)
        _close(got.params, getattr(jb, op)(*args, **kwargs).params, rtol=1e-6)
        assert torch.equal(got.type_ids, tb.type_ids)
        for i, cam in enumerate(tcams):
            p = getattr(cam, op)(*args, **kwargs).params[0]
            assert torch.equal(got.params[i, : p.shape[0]], p), (op, names[i])
    chained = tb.crop(-3.0, -5.0).resize(2.0)
    sph = names.index("Spherical")
    assert torch.equal(chained.params[sph, :8], tcams[sph].crop(-3.0, -5.0).resize(2.0).params[0])
    assert chained.params[sph, 4] == 2.0 * (PARAMS["Spherical"][0][4] + 3.0)  # W padded, then scaled
    for prop in ("hfov", "vfov"):
        _close(getattr(tb, prop), getattr(jb, prop), rtol=1e-6)


def test_newton_determinant_clamp_keeps_its_sign():
    """A Jacobian with a tiny negative determinant (-1e-14): the clamp to
    -1e-12 keeps the step finite; sign(det) * 1e-12 + 1e-12 would make it 0
    and the step inf / NaN."""

    def distort(x, y, p):
        return 1e-7 * x, -1e-7 * y

    mx = torch.tensor([[[0.3, -0.2]]])
    my = torch.tensor([[[0.1, 0.4]]])
    x, y = _newton_unproject(distort, mx, my, None, iters=1)
    jx, jy = jcam._newton_unproject(distort, jnp.asarray(mx.numpy()), jnp.asarray(my.numpy()), None, 1)
    assert torch.isfinite(x).all() and torch.isfinite(y).all()
    assert np.isfinite(np.asarray(jx)).all() and np.isfinite(np.asarray(jy)).all()
    # the step divides by the clamped determinant, so it carries the
    # forward differences' ~1e-4 relative rounding of each package
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-3)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-3)


@pytest.mark.parametrize("name", [*NAMES, "BatchCamera"])
def test_from_jax_camera(name):
    if name == "BatchCamera":
        jc = jcam.BatchCamera.concat(_mixed(NAMES)[0])
    else:
        jc = _pair(name)[0]
    tc = from_jax_camera(jc)
    assert type(tc).__name__ == name
    np.testing.assert_array_equal(tc.params.numpy(), np.asarray(jc.params))
    if name == "BatchCamera":
        assert tc.type_ids.tolist() == np.asarray(jc.type_ids).tolist()


def test_collate_of_mixed_cameras_matches_jax():
    rng = np.random.default_rng(5)
    samples = []
    for i, name in enumerate(["Pinhole", "Fisheye624", "Spherical"]):
        p = np.asarray(PARAMS[name][0], np.float32)
        samples.append({
            "image": rng.integers(0, 255, (H, W, 3), dtype=np.uint8),
            "depth": rng.uniform(0.5, 5.0, (H, W)).astype(np.float32),
            "K": np.asarray([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1]], np.float32),
            "camera_model": name,
            **({} if name == "Pinhole" else {"camera_params": p}),
        })
    got, want = collate(samples), j_collate(samples)
    np.testing.assert_allclose(got["rays"], want["rays"], atol=1e-4)

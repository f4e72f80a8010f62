"""The rest of the port's ``geometry/rays.py`` against the JAX package on
seeded inputs (fp32, CPU): the spherical <-> euclidean conversions and
``unproject_points`` at rtol 1e-5 (atol 1e-6 near 0), ``project_points``
(a scatter mean of z by truncated pixel) at rtol 1e-5, and the
morphology, ``downsample_min``, ``dilate``, ``erode`` and ``iou``,
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.geometry import rays as jrays
from unidepth_tpu_torch.geometry import rays as trays


def _close(t, j, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _K(b):
    K = np.zeros((b, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1] = np.linspace(20, 30, b), np.linspace(22, 28, b)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = 15.5, 11.0, 1.0
    return K


def test_spherical_euclidean_conversions():
    rng = np.random.default_rng(0)
    sph = np.stack([rng.uniform(-1.2, 1.2, (2, 9, 11)), rng.uniform(0.3, 2.8, (2, 9, 11)),
                    rng.uniform(0.5, 6.0, (2, 9, 11))], -1).astype(np.float32)
    _close(trays.spherical_to_euclidean(torch.from_numpy(sph)), jrays.spherical_to_euclidean(jnp.asarray(sph)))
    xyz = rng.normal(0, 2, (2, 9, 11, 3)).astype(np.float32)
    _close(trays.euclidean_to_spherical(torch.from_numpy(xyz)), jrays.euclidean_to_spherical(jnp.asarray(xyz)))
    back = trays.spherical_to_euclidean(trays.euclidean_to_spherical(torch.from_numpy(xyz)))
    torch.testing.assert_close(back, torch.from_numpy(xyz), rtol=1e-5, atol=1e-5)


def test_unproject_points():
    depth = np.random.default_rng(1).uniform(0.5, 5.0, (2, 24, 32, 1)).astype(np.float32)
    _close(trays.unproject_points(torch.from_numpy(depth), torch.from_numpy(_K(2))),
           jrays.unproject_points(jnp.asarray(depth), jnp.asarray(_K(2))))


def test_project_points():
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-1, 1, (2, 500)), rng.uniform(-1, 1, (2, 500)), rng.uniform(0.8, 4, (2, 500))],
                   -1).astype(np.float32)
    out = trays.project_points(torch.from_numpy(pts), torch.from_numpy(_K(2)), (24, 32))
    assert out.shape == (2, 24, 32, 1)
    _close(out, jrays.project_points(jnp.asarray(pts), jnp.asarray(_K(2)), (24, 32)))


@pytest.mark.parametrize("factor", [2, 3])
def test_downsample_min(factor):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 9.0, (2, 25, 31, 1)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.4] = 0.0
    _close(trays.downsample_min(torch.from_numpy(depth), factor), jrays.downsample_min(jnp.asarray(depth), factor),
           rtol=0, atol=0)


@pytest.mark.parametrize("kernel_size", [2, 3, 5])
@pytest.mark.parametrize("dtype", [np.float32, bool])
def test_dilate_erode_iou(kernel_size, dtype):
    rng = np.random.default_rng(kernel_size)
    mask = (rng.random((2, 17, 23, 1)) < 0.6).astype(dtype)
    other = (rng.random((2, 17, 23, 1)) < 0.5).astype(dtype)
    for fn in ("dilate", "erode"):
        got = getattr(trays, fn)(torch.from_numpy(mask), kernel_size)
        want = np.asarray(getattr(jrays, fn)(jnp.asarray(mask), kernel_size))
        assert got.dtype == torch.from_numpy(want).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    _close(trays.iou(torch.from_numpy(mask), torch.from_numpy(other)), jrays.iou(jnp.asarray(mask), jnp.asarray(other)),
           rtol=1e-6, atol=0)

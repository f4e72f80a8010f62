"""unidepth_tpu_torch primitives against the JAX package (fp32, CPU).

Resize in every mode the V2 serving path uses, the Fourier ray embedding,
pixel-centre coordinate grids, pinhole rays after crop/resize and the plain
attention, each on the same numpy inputs through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.geometry.cameras import Pinhole as JPinhole
from unidepth_tpu.geometry.coords import coords_grid as j_coords_grid
from unidepth_tpu.ops.attention import sdpa as j_sdpa
from unidepth_tpu.ops.fourier import generate_fourier_features as j_fourier
from unidepth_tpu.ops.resize import flat_interpolate as j_flat_interpolate
from unidepth_tpu.ops.resize import resize as j_resize
from unidepth_tpu_torch.geometry.cameras import Pinhole
from unidepth_tpu_torch.geometry.coords import coords_grid
from unidepth_tpu_torch.ops.attention import attention, sdpa
from unidepth_tpu_torch.ops.fourier import generate_fourier_features
from unidepth_tpu_torch.ops.resize import flat_interpolate, resize

ATOL = 1e-5


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "size,mode,align,aa",
    [
        ((7, 9), "bilinear", False, False),  # downscale
        ((20, 31), "bilinear", False, False),  # upscale (2x upsampler, postprocess)
        ((20, 31), "bilinear", True, False),  # decoder head resize
        ((7, 9), "bilinear", True, False),
        ((5, 7), "bilinear", False, True),  # antialiased (ray embedding)
        ((4, 5), "bicubic", False, False),  # pos-embed grid shrink
        ((11, 15), "bicubic", False, False),  # pos-embed grid growth
    ],
)
def test_resize_matches_jax(size, mode, align, aa):
    x = np.random.default_rng(0).standard_normal((2, 13, 17, 3)).astype(np.float32)
    out = resize(torch.from_numpy(x), size, mode=mode, align_corners=align, antialias=aa)
    ref = j_resize(jnp.asarray(x), size, mode=mode, align_corners=align, antialias=aa)
    assert out.shape == ref.shape
    _close(out, ref)


def test_resize_channel_first_matches_jax():
    """NCHW maps (the decoder's layout) resize over the last two axes."""
    x = np.random.default_rng(1).standard_normal((2, 4, 9, 11)).astype(np.float32)
    out = resize(torch.from_numpy(x), (18, 22), align_corners=True, channel_last=False)
    ref = j_resize(jnp.asarray(x), (18, 22), align_corners=True, channel_last=False)
    _close(out, ref)


@pytest.mark.parametrize("dtype,size", [(torch.float32, (18, 22)), (torch.bfloat16, (18, 22)), (torch.bfloat16, (9, 11))],
                         ids=["fp32", "bf16", "bf16-same-size"])
def test_resize_nhwc_keeps_the_values_in_nhwc_memory(dtype, size):
    """``nhwc``: the channel-first resize's values, held NHWC in memory (the
    V2 heads' feed of K5); it takes channel-first bilinear maps only."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 9, 11)).astype(np.float32)).to(dtype)
    out = resize(x, size, align_corners=True, channel_last=False, nhwc=True)
    assert torch.equal(out, resize(x, size, align_corners=True, channel_last=False))
    assert out.dtype == dtype and out.permute(0, 2, 3, 1).is_contiguous()
    with pytest.raises(ValueError, match="nhwc"):
        resize(x.permute(0, 2, 3, 1), size, channel_last=True, nhwc=True)
    with pytest.raises(ValueError, match="nhwc"):
        resize(x, size, mode="bicubic", channel_last=False, nhwc=True)


def test_flat_interpolate_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 20 * 30, 3)).astype(np.float32)
    out = flat_interpolate(torch.from_numpy(x), (20, 30), (5, 7))
    _close(out, j_flat_interpolate(jnp.asarray(x), (20, 30), (5, 7)))


@pytest.mark.parametrize("use_cos,cat_orig", [(False, False), (True, True)])
def test_fourier_features_match_jax(use_cos, cat_orig):
    ang = np.random.default_rng(3).uniform(-3, 3, (2, 35, 2)).astype(np.float32)
    kw = dict(dim=64, max_freq=3, use_log=True, use_cos=use_cos, cat_orig=cat_orig)
    _close(generate_fourier_features(torch.from_numpy(ang), **kw), j_fourier(jnp.asarray(ang), **kw))


def test_coords_grid_matches_jax():
    _close(coords_grid(5, 7), j_coords_grid(5, 7))


def test_pinhole_rays_after_crop_resize_match_jax():
    K = np.array(
        [[[80.0, 0, 40.0], [0, 90.0, 30.0], [0, 0, 1]], [[120.0, 0, 50.0], [0, 110.0, 25.0], [0, 0, 1]]],
        np.float32,
    )
    cam = Pinhole.from_K(torch.from_numpy(K))
    params_before = cam.params.clone()
    rays = cam.crop(-3, -2).resize(0.7).get_rays(21, 28)
    ref = JPinhole.from_K(jnp.asarray(K)).crop(-3, -2).resize(0.7).get_rays(21, 28)
    assert rays.shape == (2, 21, 28, 3)
    _close(rays, ref)
    torch.testing.assert_close(cam.params, params_before)  # the caller's camera is untouched


def test_sdpa_matches_jax_with_bias():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 3, 40, 16)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((2, 3, 40, 40)).astype(np.float32)
    out = sdpa(*map(torch.from_numpy, (q, k, v)), bias=torch.from_numpy(bias))
    _close(out, j_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias)))


def test_attention_dispatch_is_plain_on_cpu():
    """Long, unbiased CPU attention takes plain sdpa, not the flash kernel."""
    from unidepth_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 1030, 32)).astype(np.float32)) for _ in range(3))
    before = flash_attention.launches
    torch.testing.assert_close(attention(q, k, v), sdpa(q, k, v))
    assert flash_attention.launches == before


@pytest.mark.parametrize(
    "n,d,biased,to_kernel",
    [(1024, 64, False, True), (1024, 96, False, True), (1024, 128, False, True),
     (1024, 160, False, False), (1023, 64, False, False), (1024, 64, True, False)],
)
def test_attention_dispatch_off_cpu(n, d, biased, to_kernel):
    """Off the CPU the JAX rule holds: no bias, min(Nq, Nk) >= 1024 and
    d <= 128 go to the flash kernel, whatever the head dim. Here (meta
    tensors) the kernel raises instead of running plain; the rest is sdpa."""
    from unidepth_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = (torch.empty(1, 2, n, d, device="meta") for _ in range(3))
    bias = torch.empty(1, 2, n, n, device="meta") if biased else None
    before = flash_attention.launches
    if to_kernel:
        with pytest.raises((ValueError, RuntimeError)):
            attention(q, k, v, bias=bias)
    else:
        assert attention(q, k, v, bias=bias).shape == (1, 2, n, d)
    assert flash_attention.launches == before

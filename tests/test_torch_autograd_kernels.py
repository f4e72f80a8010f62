"""Gradients through the port's kernel routes K1-K4 (each a
``torch.autograd.Function``: the CUDA launch forward, the plain version's
VJP backward, the JAX ``custom_vjp`` policy).

On the CPU the launch cannot run, so the route is driven two ways:
* with the kernel library stubbed (no launch happens, the output is left
  unwritten): the output must still carry the gradient, and its backward,
  which reads only the saved inputs, must equal the plain version's;
* with the launch replaced by the plain version: ``gradcheck`` in float64.
The backward functions are held to ``jax.vjp`` of the JAX kernels (their
Pallas forward in interpret mode, their XLA backward) on the same inputs and
cotangent, fp32, at rtol 1e-5 with an absolute floor of 1e-5 x max |ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu.ops.flash_attention import flash_attention as j_flash_attention
from unidepth_tpu.ops.flash_attention import flash_attention_packed as j_flash_attention_packed
from unidepth_tpu.ops.flash_attention import flash_attention_qkv as j_flash_attention_qkv
from unidepth_tpu.ops.flash_attention import safe_attention
from unidepth_tpu.ops.fused_block import ln_dense as j_ln_dense
from unidepth_tpu_torch.ops import flash_attention as fa
from unidepth_tpu_torch.ops import fused_block as fb


class _StubLibrary:
    """The kernel library's stand-in: every entry reports success and
    writes nothing."""

    def __getattr__(self, entry):
        return lambda *args: 0


@pytest.fixture
def stub_library(monkeypatch):
    from unidepth_tpu_torch.ops import _cuda

    monkeypatch.setattr(_cuda, "library", lambda: _StubLibrary())
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)


def _rand(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# name: (route, launch attribute, plain version, wrapper, make inputs, extra args)
def _k1_inputs(rng, dtype=np.float32):
    return (_rand(rng, 2, 140, 3 * 128).astype(dtype),)


def _k3_inputs(rng, dtype=np.float32):
    return _rand(rng, 3, 140, 64).astype(dtype), _rand(rng, 3, 200, 64).astype(dtype), _rand(rng, 3, 200, 64).astype(dtype)


def _k4_inputs(rng, dtype=np.float32):
    return _rand(rng, 2, 140, 128).astype(dtype), _rand(rng, 2, 160, 128).astype(dtype), _rand(rng, 2, 160, 128).astype(dtype)


def _k2_inputs(rng, dtype=np.float32):
    c, f = 128, 256
    return (
        (rng.standard_normal((2, 75, c)) * 2 + 0.5).astype(dtype),
        (rng.standard_normal((f, c)) / np.sqrt(c)).astype(dtype),
        (0.1 * rng.standard_normal(f)).astype(dtype),
        (1 + 0.1 * rng.standard_normal(c)).astype(dtype),
        (0.1 * rng.standard_normal(c)).astype(dtype),
    )


KERNELS = {
    "K1": dict(route=fa._qkv_kernel, launch="_qkv_launch", module=fa, wrapper=fa.flash_attention_qkv,
               plain=fa.flash_attention_qkv_plain, inputs=_k1_inputs, args=(2, 0.125)),
    "K3": dict(route=fa._flash_kernel, launch="_flash_launch", module=fa, wrapper=fa.flash_attention,
               plain=fa.flash_attention_plain, inputs=_k3_inputs, args=(0.125,)),
    "K4": dict(route=fa._packed_kernel, launch="_packed_launch", module=fa, wrapper=fa.flash_attention_packed,
               plain=fa.flash_attention_packed_plain, inputs=_k4_inputs, args=(2, 0.125)),
    "K2": dict(route=fb._ln_dense_kernel, launch="_ln_dense_launch", module=fb, wrapper=fb.ln_dense,
               plain=fb.ln_dense_plain, inputs=_k2_inputs, args=(1e-6, "gelu")),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_route_keeps_the_gradient(stub_library, name):
    """The route's output requires grad when its input does (a launch that
    fills a fresh tensor would drop it), its backward equals the plain
    version's autograd, and the backward launches nothing."""
    k = KERNELS[name]
    tensors = [torch.from_numpy(a).requires_grad_() for a in k["inputs"](np.random.default_rng(0))]
    before = k["wrapper"].launches
    out = k["route"](*tensors, *k["args"])
    assert out.requires_grad and out.grad_fn is not None
    assert k["wrapper"].launches == before + 1
    g = torch.from_numpy(_rand(np.random.default_rng(1), *out.shape))
    grads = torch.autograd.grad(out, tensors, g)
    assert k["wrapper"].launches == before + 1  # forward launches only
    ref = torch.autograd.grad(k["plain"](*tensors, *k["args"]), tensors, g)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_route_gradcheck_float64(monkeypatch, name):
    """With the launch replaced by the plain version, the route's backward
    passes ``gradcheck`` in float64 (small shapes)."""
    k = KERNELS[name]
    plain = k["plain"]
    monkeypatch.setattr(k["module"], k["launch"], lambda *a: plain(*a))
    rng = np.random.default_rng(2)
    shapes = {"K1": [(1, 6, 3 * 16)], "K3": [(2, 5, 8), (2, 7, 8), (2, 7, 8)], "K4": [(1, 5, 16), (1, 6, 16), (1, 6, 16)],
              "K2": [(5, 8), (12, 8), (12,), (8,), (8,)]}[name]
    tensors = tuple(torch.from_numpy(rng.standard_normal(s)).requires_grad_() for s in shapes)
    args = k["args"] if name != "K4" else (2, 0.3)
    assert torch.autograd.gradcheck(lambda *t: k["route"](*t, *args), tensors, eps=1e-6, atol=1e-8, rtol=1e-6)


def _close(got: torch.Tensor, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _jax_vjp(fn, inputs, g):
    with pltpu.force_tpu_interpret_mode(), safe_attention():
        _, vjp = jax.vjp(fn, *map(jnp.asarray, inputs))
        return vjp(jnp.asarray(g))


def test_k1_backward_matches_jax_vjp():
    """The JAX kernel takes q pre-scaled; the port applies ``scale`` inside,
    so its gradient of the q columns is JAX's times ``scale``."""
    rng = np.random.default_rng(3)
    (qkv,) = _k1_inputs(rng)
    c, heads, scale = 128, 2, 0.125
    g = _rand(rng, 2, 140, c)
    pre = qkv.copy()
    pre[..., :c] *= scale
    (ref,) = _jax_vjp(lambda t: j_flash_attention_qkv(t, heads), (pre,), g)
    got = fa._flash_attention_qkv_bwd(torch.from_numpy(qkv), torch.from_numpy(g), heads, scale)
    ref = np.asarray(ref).copy()
    ref[..., :c] *= scale
    _close(got, ref)


def test_k3_backward_matches_jax_vjp():
    rng = np.random.default_rng(4)
    q, k, v = _k3_inputs(rng)
    g = _rand(rng, *q.shape)
    refs = _jax_vjp(lambda q, k, v: j_flash_attention(q, k, v, None, None, 0.125), (q, k, v), g)
    gots = fa._flash_attention_bwd(*map(torch.from_numpy, (q, k, v, g)), 0.125)
    for got, ref in zip(gots, refs):
        _close(got, ref)


def test_k4_backward_matches_jax_vjp():
    rng = np.random.default_rng(5)
    q, k, v = _k4_inputs(rng)
    g = _rand(rng, *q.shape)
    refs = _jax_vjp(lambda q, k, v: j_flash_attention_packed(q, k, v, 2, 0.125), (q, k, v), g)
    gots = fa._flash_attention_packed_bwd(*map(torch.from_numpy, (q, k, v, g)), 2, 0.125)
    for got, ref in zip(gots, refs):
        _close(got, ref)


def test_k2_backward_matches_jax_vjp():
    """JAX holds the kernel as (C, F), the port as (F, C): the weight
    gradients are each other's transpose."""
    rng = np.random.default_rng(6)
    x, w, b, gamma, beta = _k2_inputs(rng)
    g = _rand(rng, 2, 75, w.shape[0])
    refs = _jax_vjp(lambda x, w, b, gm, bt: j_ln_dense(x, w, b, gm, bt, 1e-6, "gelu"), (x, w.T, b, gamma, beta), g)
    gots = fb._ln_dense_bwd(*map(torch.from_numpy, (x, w, b, gamma, beta, g)), 1e-6, "gelu")
    refs = list(refs)
    refs[1] = np.asarray(refs[1]).T
    for got, ref in zip(gots, refs):
        _close(got, ref)


def test_bf16_route_returns_bf16_gradients(stub_library):
    """On bf16 inputs the backward recomputes in the plain version's dtypes
    (fp32 scores and softmax) and returns gradients in the inputs' dtype."""
    qkv = torch.from_numpy(_k1_inputs(np.random.default_rng(7))[0]).bfloat16().requires_grad_()
    out = fa._qkv_kernel(qkv, 2, 0.125)
    (grad,) = torch.autograd.grad(out, qkv, torch.ones_like(out))
    assert grad.dtype == torch.bfloat16 and torch.isfinite(grad.float()).all()

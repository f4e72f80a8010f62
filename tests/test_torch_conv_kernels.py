"""K5 conv3x3_lowchannel: the port's op on the CPU (its plain version)
against the JAX Pallas kernel in TPU interpret mode, on the JAX test's three
shapes and padding modes, fp32 at 1e-4 and bf16 at 1.6e-2 (bf16 output
rounding); x, w and bias gradients against ``jax.grad`` of the JAX op at
1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unidepth_tpu.ops.conv_kernels import conv3x3_lowchannel as j_conv3x3
from unidepth_tpu_torch.ops.conv_kernels import conv3x3_lowchannel

CASES = [((2, 21, 37, 16, 8), "reflect"), ((1, 10, 40, 32, 16), "zeros"), ((1, 9, 13, 8, 4), "replicate")]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4), "bfloat16": (jnp.bfloat16, torch.bfloat16, 1.6e-2)}


def _inputs(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, h, w, cin)).astype(np.float32),
        (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32),
        (rng.standard_normal((cout,)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,mode", CASES)
def test_conv3x3_lowchannel_matches_pallas(shape, mode, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(shape, sum(shape))
    with pltpu.force_tpu_interpret_mode():
        ref = j_conv3x3(*(jnp.asarray(a, jdt) for a in arrays), mode, 4)
    ref = np.asarray(ref.astype(jnp.float32))
    before = conv3x3_lowchannel.launches
    out = conv3x3_lowchannel(*(torch.from_numpy(a).to(tdt) for a in arrays), mode, 4)
    assert conv3x3_lowchannel.launches == before  # CPU tensors run the plain version
    assert out.dtype == tdt and out.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol)


def test_conv3x3_lowchannel_without_bias_and_rows_hint():
    """No bias, and ``rows`` (the TPU strip height) changes nothing."""
    x, w, _ = _inputs((1, 9, 13, 8, 4), 3)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_conv3x3(jnp.asarray(x), jnp.asarray(w), None, "reflect", 4))
    for rows in (1, 4, 8):
        out = conv3x3_lowchannel(torch.from_numpy(x), torch.from_numpy(w), None, "reflect", rows)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="padding_mode"):
        conv3x3_lowchannel(torch.from_numpy(x), torch.from_numpy(w), None, "circular")


@pytest.mark.parametrize("mode", ["zeros", "reflect", "replicate"])
def test_conv3x3_lowchannel_grads_match_jax(mode):
    x, w, bias = _inputs((1, 8, 12, 8, 4), 7)

    def loss(x, w, bias):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(j_conv3x3(x, w, bias, mode, 4) ** 2)

    refs = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, bias)))
    tensors = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    (conv3x3_lowchannel(*tensors, mode) ** 2).sum().backward()
    for ref, t in zip(refs, tensors):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_conv3x3_lowchannel_grad_of_x_alone():
    """Only the inputs that need a gradient get one."""
    x, w, bias = _inputs((1, 8, 12, 8, 4), 8)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w)
    conv3x3_lowchannel(xt, wt, torch.from_numpy(bias), "zeros").sum().backward()
    assert xt.grad.shape == xt.shape and wt.grad is None

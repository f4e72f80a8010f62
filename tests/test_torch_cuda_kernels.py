"""unidepth_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA Hopper card and nvcc; without a card they skip. On the
card, run them alone (the suite's conftest imports JAX, which that machine
need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

bf16 I/O runs the tensor-core kernels the model launches (attn_fwd_bf16,
which K1, K3 and K4 share, and ln_dense_bf16). Each is held against its
plain version computed in fp32 from the same bf16 inputs, elementwise at
rtol 1.6e-2, atol 1e-2 (bf16 output rounding) and, tighter, at a relative RMS error
||out - ref|| / ||ref|| <= 5e-3. The attention outputs here are ~0.05 in
size, so the elementwise bound alone would pass a kernel whose softmax
denominator is off by 2%; the RMS bound would not (rounding alone gives
~2e-3). fp32 I/O runs the CUDA-core kernels (attn_fwd_simt,
ln_dense_simt), held at 1e-4 (attention) and 2e-4 (ln_dense, a 1024-long
fp32 dot product per output). The int8 GEMM of the int8 serving path
(``torch._int_mm``, padded for M <= 16) is held exactly against an integer
product and its dequant against float64. K5 (conv3x3_lowchannel) is held
like the others, in bf16 and fp32, at the V2 heads' hr conv shape and the
JAX test's shapes in all three padding modes. K6 and K7 (the A/B attention
variants, bf16 only on the card) are held against their plain versions at
the bf16 gates with the elementwise atol scaled by the output's size,
``noexp`` (outputs ~1e31) by relative RMS alone.
"""

import numpy as np
import pytest
import torch

from unidepth_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_packed,
    flash_attention_packed_plain,
    flash_attention_plain,
    flash_attention_qkv,
    flash_attention_qkv_plain,
)
from unidepth_tpu_torch.ops.attention import attention
from unidepth_tpu_torch.ops.conv_kernels import conv3x3_lowchannel, conv3x3_lowchannel_plain
from unidepth_tpu_torch.ops.kernel_ab import run_bd, run_variant, run_variant_plain
from unidepth_tpu_torch.ops.fused_block import ln_dense, ln_dense_plain
from unidepth_tpu_torch.ops.quant import QuantLinear, dynamic_quant, int8_matmul

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
REL_RMS_BF16 = 5e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)


def _close(out, ref, dtype, fp32_tol):
    tol = TOL.get(dtype, dict(rtol=fp32_tol, atol=fp32_tol))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    if dtype == torch.bfloat16:
        rel_rms = ((out.float() - ref).norm() / ref.norm()).item()
        assert rel_rms <= REL_RMS_BF16, rel_rms


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,n,c,h", [(2, 140, 128, 2), (2, 200, 256, 8), (1, 130, 256, 2), (8, 1370, 1024, 16)]
)
def test_flash_attention_qkv_matches_plain(dev, dtype, b, n, c, h):
    rng = np.random.default_rng(0)
    qkv = _t(rng.standard_normal((b, n, 3 * c)), dev, dtype)
    scale = (c // h) ** -0.5
    before = flash_attention_qkv.launches
    out = flash_attention_qkv(qkv, h, scale)
    torch.cuda.synchronize()
    assert flash_attention_qkv.launches == before + 1
    ref = flash_attention_qkv_plain(qkv.float(), h, scale)
    _close(out, ref, dtype, 1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "bh,nq,nk,d",
    [(3, 200, 200, 64), (4, 70, 300, 32), (2, 1369, 1369, 128), (64, 1369, 1369, 64), (4, 150, 300, 8)],
)
def test_flash_attention_matches_plain(dev, dtype, bh, nq, nk, d):
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((bh, nq, d)), dev, dtype)
    k = _t(rng.standard_normal((bh, nk, d)), dev, dtype)
    v = _t(rng.standard_normal((bh, nk, d)), dev, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q.float(), k.float(), v.float(), d**-0.5)
    _close(out, ref, dtype, 1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "m,c,f,eps,act",
    [(300, 128, 512, 1e-6, "gelu"), (1000, 256, 384, 1e-5, None), (10960, 1024, 4096, 1e-6, "gelu")],
)
def test_ln_dense_matches_plain(dev, dtype, m, c, f, eps, act):
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((m, c)) * 2 + 0.5, dev, dtype)
    w = _t(rng.standard_normal((f, c)) / np.sqrt(c), dev, dtype)
    b = _t(rng.standard_normal(f) * 0.1, dev, dtype)
    g = _t(1 + 0.1 * rng.standard_normal(c), dev, dtype)
    bt = _t(0.1 * rng.standard_normal(c), dev, dtype)
    before = ln_dense.launches
    out = ln_dense(x, w, b, g, bt, eps, act)
    torch.cuda.synchronize()
    assert ln_dense.launches == before + 1
    ref = ln_dense_plain(x.float(), w.float(), b.float(), g.float(), bt.float(), eps, act)
    _close(out, ref, dtype, 2e-4)


@pytest.mark.parametrize("d", [48, 96])
def test_attention_head_dim_without_kernel_raises(dev, d):
    """The dispatch sends d <= 128 to the kernel, as JAX does; a head dim the
    kernel lacks raises on the card instead of running plain."""
    q, k, v = (torch.randn(1, 2, 1024, d, device=dev, dtype=torch.bfloat16) for _ in range(3))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "b,nq,nk,c,h,views",
    [
        (8, 1370, 1370, 1024, 16, True),  # the int8 path: views of one (8, 1370, 3072) projection
        (2, 140, 140, 128, 2, True),
        (2, 70, 300, 256, 4, False),  # Nq != Nk
        (1, 130, 130, 128, 8, True),  # ragged tail, d=16
        (2, 150, 150, 128, 16, True),  # d=8: the zero-filled 16-deep mma step
    ],
    ids=["path", "views", "nq-ne-nk", "ragged-d16", "ragged-d8"],
)
def test_flash_attention_packed_matches_plain(dev, dtype, b, nq, nk, c, h, views):
    rng = np.random.default_rng(3)
    if views:
        q, k, v = _t(rng.standard_normal((b, nq, 3 * c)), dev, dtype).split(c, dim=-1)
    else:
        q = _t(rng.standard_normal((b, nq, c)), dev, dtype)
        k, v = (_t(rng.standard_normal((b, nk, c)), dev, dtype) for _ in range(2))
    before = flash_attention_packed.launches, flash_attention.launches
    out = flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    assert (flash_attention_packed.launches, flash_attention.launches) == (before[0] + 1, before[1])
    ref = flash_attention_packed_plain(q.float(), k.float(), v.float(), h, (c // h) ** -0.5)
    _close(out, ref, dtype, 1e-4)


def test_flash_attention_packed_routes_long_keys_to_k3(dev):
    """Past 4096 keys the packed regime ends; the call goes to K3 (head split)."""
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((1, 64, 128)), dev, torch.bfloat16)
    k, v = (_t(rng.standard_normal((1, 4200, 128)), dev, torch.bfloat16) for _ in range(2))
    before = flash_attention_packed.launches, flash_attention.launches
    out = flash_attention_packed(q, k, v, 2)
    torch.cuda.synchronize()
    assert (flash_attention_packed.launches, flash_attention.launches) == (before[0], before[1] + 1)
    _close(out, flash_attention_packed_plain(q.float(), k.float(), v.float(), 2, 64**-0.5), torch.bfloat16, 0)


def test_flash_attention_packed_rejects_unaligned_rows(dev):
    x = torch.randn(2, 140, 3 * 128 + 4, device=dev, dtype=torch.bfloat16)
    before = flash_attention_packed.launches
    with pytest.raises(ValueError, match="row strides"):
        flash_attention_packed(x[..., :128], x[..., 128:256], x[..., 256:384], 2)
    assert flash_attention_packed.launches == before


def test_flash_attention_packed_rejects_unaligned_views(dev):
    """Strides that are multiples of 8 but views that start 8 bytes into a
    row: the 16-byte loads would fault, so the wrapper raises first."""
    x = torch.randn(2, 140, 3 * 128 + 8, device=dev, dtype=torch.bfloat16)
    before = flash_attention_packed.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_packed(x[..., 4:132], x[..., 132:260], x[..., 260:388], 2)
    torch.cuda.synchronize()  # the context is still healthy
    assert flash_attention_packed.launches == before


@pytest.mark.parametrize("m", [5, 16, 17, 10960])
def test_int8_matmul_is_exact(dev, m):
    """torch._int_mm on the card: row-major int8 activations, the weight's
    (N, K) storage read as the column-major operand, M <= 16 padded."""
    rng = np.random.default_rng(5)
    k, n = 1024, 3072
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    out = int8_matmul(xq.to(dev), wq.to(dev))
    assert out.dtype == torch.int32 and out.shape == (m, n)
    torch.testing.assert_close(out.cpu().long(), xq.long() @ wq.long().T, rtol=0, atol=0)


@pytest.mark.parametrize("m", [5, 10960])
def test_quant_linear_matches_float64(dev, m):
    rng = np.random.default_rng(6)
    k, n = 1024, 4096
    w = torch.from_numpy((rng.standard_normal((n, k)) * k**-0.5).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    layer = QuantLinear.from_float(w, b, device=dev)
    assert layer.weight.is_contiguous() and layer.weight.t().stride() == (1, k)
    x = _t(rng.standard_normal((m, k)), dev, torch.float32)
    out = layer(x)
    q, s = dynamic_quant(x)
    ref = (q.double() @ layer.weight.double().T) * (s.double() * layer.scale.double()) + layer.bias.double()
    torch.testing.assert_close(out.double(), ref, rtol=1e-5, atol=1e-5)
    assert layer(x.to(torch.bfloat16)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="multiples of 8"):
        QuantLinear.from_float(w[:, :1020], device=dev)(x[:, :1020])


def _rel_rms(out, ref):
    top = ref.abs().max()
    return ((out.float() - ref) / top).norm().item() / (ref / top).norm().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "shape,mode",
    [
        ((8, 518, 518, 64, 32), "reflect"),  # the V2 heads' hr conv
        ((2, 37, 45, 64, 32), "zeros"),
        ((2, 37, 45, 64, 32), "replicate"),
        ((2, 21, 37, 16, 8), "reflect"),
        ((1, 10, 40, 32, 16), "zeros"),
        ((1, 9, 13, 8, 4), "replicate"),
        ((1, 5, 70, 24, 3), "reflect"),  # Cin and Cout off the mma granule, odd Cout
    ],
)
def test_conv3x3_lowchannel_matches_plain(dev, dtype, shape, mode):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((b, h, w, cin)), dev, dtype)
    wk = _t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin), dev, dtype)
    bias = _t(rng.standard_normal(cout) * 0.1, dev, dtype)
    before = conv3x3_lowchannel.launches
    out = conv3x3_lowchannel(x, wk, bias, mode)
    torch.cuda.synchronize()
    assert conv3x3_lowchannel.launches == before + 1
    ref = conv3x3_lowchannel_plain(x.float(), wk.float(), bias.float(), mode)
    _close(out, ref, dtype, 1e-4)


def test_conv3x3_lowchannel_grad_on_the_card(dev):
    """The forward launches the kernel; the backward recomputes the plain
    version, so the gradients are the plain version's."""
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 20, 30, 16)), dev, torch.float32)
    wk = _t(rng.standard_normal((3, 3, 16, 8)) * 0.1, dev, torch.float32)
    bias = _t(rng.standard_normal(8) * 0.1, dev, torch.float32)
    grads = []
    for fn in (conv3x3_lowchannel, conv3x3_lowchannel_plain):
        ts = [t.clone().requires_grad_() for t in (x, wk, bias)]
        (fn(*ts, "reflect") ** 2).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_conv3x3_lowchannel_rejects_what_it_lacks(dev):
    x = torch.randn(1, 8, 8, 12, device=dev, dtype=torch.bfloat16)
    before = conv3x3_lowchannel.launches
    with pytest.raises(ValueError, match="multiple of 8"):
        conv3x3_lowchannel(x, torch.randn(3, 3, 12, 4, device=dev, dtype=torch.bfloat16), None)
    with pytest.raises(ValueError, match="Cout"):
        conv3x3_lowchannel(x.float(), torch.randn(3, 3, 12, 40, device=dev), None)
    assert conv3x3_lowchannel.launches == before


AB_FAMILY_NAMES = ["tr_max", "bf16p", "nomax_guard", "tr_lmxu", "nomax", "noexp", "gemmonly", "qk_only", "pv_only"]


def _ab_inputs(dev, b, n, c):
    rng = np.random.default_rng(9)
    return tuple(_t(rng.standard_normal((b, n, c)), dev, torch.bfloat16) for _ in range(3))


def _ab_close(variant, out, ref):
    """The bf16 gates, atol scaled by max(1, max |ref|): the unnormalised
    families (gemmonly, qk_only, pv_only) are sums of ~N terms, ~10-100."""
    if variant != "noexp":
        torch.testing.assert_close(out.float(), ref, rtol=1.6e-2, atol=1e-2 * max(1.0, ref.abs().max().item()))
    assert torch.isfinite(out).all()
    assert _rel_rms(out, ref) <= REL_RMS_BF16


@pytest.mark.parametrize("variant", AB_FAMILY_NAMES)
@pytest.mark.parametrize("b,n,heads,d", [(2, 200, 4, 64), (1, 150, 4, 32), (8, 1370, 16, 64)])
def test_run_variant_matches_plain(dev, variant, b, n, heads, d):
    q, k, v = _ab_inputs(dev, b, n, heads * d)
    before = run_variant.launches
    out = run_variant(variant, q, k, v, heads, d**-0.5)
    torch.cuda.synchronize()
    assert run_variant.launches == before + 1
    _ab_close(variant, out, run_variant_plain(variant, q.float(), k.float(), v.float(), heads, d**-0.5))


@pytest.mark.parametrize("variant", ["bd", "bd_lmxu", "bd176"])
@pytest.mark.parametrize("b,n,heads", [(2, 200, 4), (8, 1370, 16)])
def test_run_bd_matches_plain(dev, variant, b, n, heads):
    q, k, v = _ab_inputs(dev, b, n, heads * 64)
    before = run_bd.launches, run_variant.launches
    out = run_variant(variant, q, k, v, heads, 0.125)
    torch.cuda.synchronize()
    assert (run_bd.launches, run_variant.launches) == (before[0] + 1, before[1])
    _ab_close(variant, out, run_variant_plain(variant, q.float(), k.float(), v.float(), heads, 0.125))


def test_ab_kernels_take_bf16_only(dev):
    q = torch.randn(1, 150, 128, device=dev)
    before = run_variant.launches, run_bd.launches
    with pytest.raises(ValueError, match="bf16"):
        run_variant("tr_max", q, q, q, 4, 32**-0.5)
    with pytest.raises(ValueError, match="bf16"):
        run_bd(q, q, q, 2, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        run_variant("tr_max", *(q.to(torch.bfloat16),) * 3, 8, 16**-0.5)
    assert (run_variant.launches, run_bd.launches) == before

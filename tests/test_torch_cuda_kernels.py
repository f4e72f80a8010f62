"""unidepth_tpu_torch's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA Hopper card and nvcc; without a card they skip. On the
card, run them alone (the suite's conftest imports JAX, which that machine
need not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

bf16 I/O runs the tensor-core kernels the model launches (at head dim 64
attn_fwd_wgmma, the Hopper body K1, K3 and K4 share with K6 and K7, and K3's
at 32 and 48; at the other head dims, every multiple of 8 up to 128,
attn_fwd_bf16; ln_dense_wgmma for K2 on its gate, ln_dense_bf16 off it;
conv3x3_wgmma for K5 with Cin and Cout multiples of 8, conv3x3_bf16 off it).
Each is held against its
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
JAX test's shapes in all three padding modes; its Hopper body at the hr
shapes of ViT-L, ViT-B and ViT-S, ragged and exact strips, 1-5 rows and
every padding mode at both borders; its mma.sync body through its C entry;
its fused head (``conv3x3_head``: the V2 heads' hr tail, 3x3 reflect,
LeakyReLU, 1x1 to one channel) at the hr shape and the cameras' network
shapes, against its plain version, and a V2 ViT-L/14 ``infer()`` that
routes both heads to it, against the fp32 module path.
K6 and K7 (the A/B attention
variants, bf16 only on the card; the Hopper body at head dim 64, K6's
mma.sync body at 32) are held against their plain versions at the bf16
gates with the elementwise atol scaled by the output's size, ``noexp``
(outputs ~1e31) by relative RMS alone. UniDepthV2 ViT-B/14 and ViT-S/14,
whose decoders attend at head dims 48 and 32, run ``infer()`` at 518x518
against their fp32 plain paths. K1, K2 and K3 also run at the UniDepthV1
shapes (462x616 at B = 8: K1 at 1453 tokens, K3 at 1452 and 1064, K2 at
ConvNeXt-L's four stages and the V1 decoder's three CvnxtBlock widths), and
UniDepthV1 ViT-L/14 and ConvNeXt-L at full width with the encoder's depth
cut run ``infer()`` against their fp32 plain paths at the V1 gate.
"""

import json
from pathlib import Path

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
from unidepth_tpu_torch.ops.conv_kernels import (
    conv3x3_head,
    conv3x3_head_plain,
    conv3x3_lowchannel,
    conv3x3_lowchannel_plain,
)
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
    [(3, 200, 200, 64), (4, 70, 300, 32), (2, 1369, 1369, 128), (64, 1369, 1369, 64), (4, 150, 300, 8),
     (16, 1369, 1369, 48), (4, 150, 300, 96), (3, 200, 170, 24), (2, 130, 130, 120), (2, 70, 90, 40)],
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


@pytest.mark.parametrize("d", [20])
def test_attention_head_dim_without_kernel_raises(dev, d):
    """The dispatch sends d <= 128 to the kernel, as JAX does; a head dim off
    the kernel's grid (multiples of 8: 16-byte rows) raises on the card
    instead of running plain."""
    q, k, v = (torch.randn(1, 2, 1024, d, device=dev, dtype=torch.bfloat16) for _ in range(3))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dim"):
        attention(q, k, v)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [48, 96])
def test_attention_head_dim_48_and_96_run_the_kernel(dev, dtype, d):
    """The ViT-B decoder's head dim (48) and twice it: the dispatch takes K3,
    on the Hopper body in bf16 at 48 and on attention.cu's bodies otherwise,
    at the plain version's gates."""
    rng = np.random.default_rng(d)
    q, k, v = (_t(rng.standard_normal((2, 4, 1100, d)), dev, dtype) for _ in range(3))
    before = flash_attention.launches, flash_attention.hopper_launches
    out = attention(q, k, v)
    torch.cuda.synchronize()
    hopper = dtype == torch.bfloat16 and d == 48
    assert (flash_attention.launches, flash_attention.hopper_launches) == (before[0] + 1, before[1] + hopper)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), d**-0.5)
    _close(out, ref, dtype, 1e-4)


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


# ---- K5's Hopper body (conv3x3_wgmma.cu: bf16, Cin and Cout multiples of 8) ----

K5_HOPPER_CASES = [
    ((8, 518, 518, 64, 32), "reflect"),  # the hr convs of ViT-L/14, ViT-B/14 and ViT-S/14
    ((8, 518, 518, 48, 32), "reflect"),
    ((8, 518, 518, 32, 32), "reflect"),
    ((1, 7, 518, 64, 32), "zeros"),  # W = 518: 9 strips, the last with 6 pixels
    ((2, 6, 70, 64, 32), "replicate"),  # W = 70: a strip and 6 pixels
    ((2, 6, 64, 32, 32), "reflect"),  # W = 64: exactly one strip
    ((3, 1, 70, 32, 32), "zeros"),  # H = 1..5
    ((2, 1, 70, 64, 32), "replicate"),
    ((2, 2, 70, 48, 32), "reflect"),
    ((2, 3, 70, 64, 32), "zeros"),
    ((1, 4, 130, 32, 32), "replicate"),
    ((2, 5, 130, 48, 32), "reflect"),
    ((2, 9, 130, 64, 32), "zeros"),  # every mode at both borders: 3 strips, the last with 2 pixels
    ((2, 9, 130, 64, 32), "reflect"),
    ((2, 9, 130, 64, 32), "replicate"),
    ((1, 9, 66, 8, 8), "reflect"),  # every Cout and Cin / 16 the body instantiates
    ((1, 9, 66, 24, 16), "replicate"),
    ((1, 9, 66, 40, 24), "zeros"),
    ((2, 33, 45, 16, 8), "reflect"),
]


@pytest.mark.parametrize("shape,mode", K5_HOPPER_CASES, ids=[f"{'x'.join(map(str, s))}-{m}" for s, m in K5_HOPPER_CASES])
def test_conv3x3_lowchannel_hopper_body(dev, shape, mode):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = _t(rng.standard_normal((b, h, w, cin)), dev, torch.bfloat16)
    wk = _t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin), dev, torch.bfloat16)
    bias = _t(rng.standard_normal(cout) * 0.1, dev, torch.bfloat16)
    before = conv3x3_lowchannel.launches, conv3x3_lowchannel.hopper_launches
    out = conv3x3_lowchannel(x, wk, bias, mode)
    torch.cuda.synchronize()
    assert (conv3x3_lowchannel.launches, conv3x3_lowchannel.hopper_launches) == (before[0] + 1, before[1] + 1)
    _close(out, conv3x3_lowchannel_plain(x.float(), wk.float(), bias.float(), mode), torch.bfloat16, 0)


def test_conv3x3_lowchannel_hopper_body_without_bias(dev):
    rng = np.random.default_rng(15)
    x = _t(rng.standard_normal((2, 11, 100, 64)), dev, torch.bfloat16)
    wk = _t(rng.standard_normal((3, 3, 64, 32)) / 24, dev, torch.bfloat16)
    before = conv3x3_lowchannel.hopper_launches
    out = conv3x3_lowchannel(x, wk, None, "reflect")
    torch.cuda.synchronize()
    assert conv3x3_lowchannel.hopper_launches == before + 1
    _close(out, conv3x3_lowchannel_plain(x.float(), wk.float(), None, "reflect"), torch.bfloat16, 0)


@pytest.mark.parametrize(
    "shape,mode",
    [((8, 518, 518, 64, 32), "reflect"), ((2, 37, 45, 64, 32), "zeros"), ((2, 37, 45, 64, 32), "replicate"),
     ((2, 21, 37, 16, 8), "reflect"), ((1, 10, 40, 32, 16), "zeros")],
)
def test_conv3x3_mma_sync_entry_matches_plain(dev, shape, mode):
    """The mma.sync body of conv3x3.cu at the bf16 shapes the route now
    sends to the Hopper body, through its C entry (no wrapper counts it)."""
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.ops.conv_kernels import PAD_MODES

    b, h, w, cin, cout = shape
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((b, h, w, cin)), dev, torch.bfloat16)
    wk = _t(rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin), dev, torch.bfloat16)
    bias = _t(rng.standard_normal(cout) * 0.1, dev, torch.bfloat16)
    out = torch.empty((b, h, w, cout), dtype=torch.bfloat16, device=dev)
    err = _cuda.library().ud_conv3x3_fwd(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w, cin, cout, PAD_MODES[mode],
        _cuda.DTYPE_CODES[torch.bfloat16], _cuda.stream_handle(x))
    _cuda.check(err, "ud_conv3x3_fwd")
    torch.cuda.synchronize()
    _close(out, conv3x3_lowchannel_plain(x.float(), wk.float(), bias.float(), mode), torch.bfloat16, 0)


# ---- K5's fused head (conv3x3_head: the V2 heads' hr tail on the Hopper body) ----

K5_HEAD_CASES = [
    (8, 518, 518, 64),  # ViT-L/14 at 518 x 518
    (8, 490, 644, 64),  # the cameras' network inputs: 480x640, 375x1242, 768x1024, 1080x1920
    (8, 490, 1232, 64),
    (8, 672, 896, 64),
    (8, 588, 1036, 64),
    (2, 9, 70, 48),  # ViT-B/14's and ViT-S/14's Cin, ragged and exact strips
    (2, 5, 64, 32),
]


def _head_close(out, ref):
    """The bf16 gates, the elementwise atol scaled by max(1, max |ref|) as
    K6's: the head sums Cout bf16 conv outputs, and where the kernel's fp32
    sum and the reference's round one of them to neighbouring bf16 values (1
    output in ~5e6 at the cameras' shapes) the head moves by |w1| times that
    ulp, ~0.011 at a conv output of ~4."""
    torch.testing.assert_close(out.float(), ref, rtol=1.6e-2, atol=1e-2 * max(1.0, ref.abs().max().item()))
    assert ((out.float() - ref).norm() / ref.norm()).item() <= REL_RMS_BF16


@pytest.mark.parametrize("b,h,w,cin", K5_HEAD_CASES, ids=["x".join(map(str, c)) for c in K5_HEAD_CASES])
def test_conv3x3_head_hopper_body(dev, b, h, w, cin):
    rng = np.random.default_rng(h + w + cin)
    x = _t(rng.standard_normal((b, h, w, cin)), dev, torch.bfloat16)
    wk = _t(rng.standard_normal((3, 3, cin, 32)) / np.sqrt(9 * cin), dev, torch.bfloat16)
    bias = _t(rng.standard_normal(32) * 0.1, dev, torch.bfloat16)
    w1 = _t(rng.standard_normal(32) / np.sqrt(32), dev, torch.bfloat16)
    b1 = _t(rng.standard_normal(1) * 0.1, dev, torch.bfloat16)
    before = conv3x3_lowchannel.launches, conv3x3_lowchannel.hopper_launches
    out = conv3x3_head(x, wk, bias, w1, b1, "reflect", 0.01)
    torch.cuda.synchronize()
    assert (conv3x3_lowchannel.launches, conv3x3_lowchannel.hopper_launches) == (before[0] + 1, before[1] + 1)
    assert out.shape == (b, h, w, 1) and out.dtype == torch.bfloat16
    # the plain version on the same bf16 inputs rounds where the kernel rounds (the conv's output, the
    # LeakyReLU, the 1x1's sum): against an fp32 composition the rounding of 32 conv outputs alone
    # reaches the elementwise atol where the head's output is near 0
    _head_close(out, conv3x3_head_plain(x, wk, bias, w1, b1, "reflect", 0.01).float())


def test_conv3x3_head_hopper_body_without_biases(dev):
    rng = np.random.default_rng(16)
    x = _t(rng.standard_normal((2, 11, 100, 64)), dev, torch.bfloat16)
    wk = _t(rng.standard_normal((3, 3, 64, 32)) / 24, dev, torch.bfloat16)
    w1 = _t(rng.standard_normal(32) / np.sqrt(32), dev, torch.bfloat16)
    out = conv3x3_head(x, wk, None, w1, None, "reflect", 0.2)
    torch.cuda.synchronize()
    _head_close(out, conv3x3_head_plain(x, wk, None, w1, None, "reflect", 0.2).float())


def test_vitl14_v2_infer_routes_the_heads_to_k5(dev):
    """UniDepthV2 ViT-L/14 at 518x518, B = 2: a bf16 ``infer()`` launches the
    fused K5 once a head (once with the confidence left out), K1-K3 as
    before, and its depth is the fp32 module path's within the ViT-L gate
    (median relative error <= 1e-2); ``set_kernels(False)``, fp32 and a
    forward under autograd launch no K5."""
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / "config_v2_vitl14.json").read_text())
    rgb = np.random.default_rng(0).integers(0, 256, (2, 518, 518, 3), dtype=np.uint8)
    model = UniDepthV2.from_config(cfg).init_params(seed=0).eval()
    counted = (flash_attention_qkv, ln_dense, flash_attention, flash_attention_packed, conv3x3_lowchannel)

    def launches(call):
        for fn in counted:
            fn.launches = fn.hopper_launches = 0
        out = call()
        torch.cuda.synchronize()
        return out, [(fn.launches, fn.hopper_launches) for fn in counted]

    out, got = launches(lambda: model.infer(rgb))
    assert got == [(24, 24), (24, 24), (4, 4), (0, 0), (2, 2)]
    assert launches(lambda: model.infer(rgb, outputs=("depth",)))[1][-1] == (1, 1)
    ref_model = UniDepthV2.from_config(cfg, device=dev, dtype=torch.float32).init_params(seed=0).eval()
    assert launches(lambda: ref_model.infer(rgb[:1], outputs=("depth",)))[1][-1] == (0, 0)  # fp32
    ref = ref_model.set_kernels(False).infer(rgb)
    for key in ("depth", "confidence"):
        assert out[key].shape == ref[key].shape == (2, 518, 518, 1)
        assert torch.isfinite(out[key]).all()
    rel = ((out["depth"] - ref["depth"]).abs() / ref["depth"].abs()).flatten()
    assert rel.median().item() <= 1e-2
    image = torch.zeros(1, 518, 518, 3, device=dev)
    assert launches(lambda: model.encode_decode(image)["depth"].sum().backward())[1][-1] == (0, 0)  # autograd
    model.zero_grad(set_to_none=True)
    assert launches(lambda: model.set_kernels(False).infer(rgb, outputs=("depth",)))[1] == [(0, 0)] * 5


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


AB_HOPPER_SHAPES = [
    (8, 1370, 1370, 16),  # the harness shape: a ragged last key tile
    (2, 300, 1500, 4),  # Nq != Nk
    (2, 200, 70, 4),  # Nk below one key tile
    (1, 150, 40, 2),  # Nk below 64: M8 stores keys past Nk as zero scores
]
AB_HOPPER_IDS = [f"b{b}-nq{nq}-nk{nk}-h{h}" for b, nq, nk, h in AB_HOPPER_SHAPES]


def _ab_hopper_inputs(dev, b, nq, nk, c):
    rng = np.random.default_rng(nq + nk)
    q = _t(rng.standard_normal((b, nq, c)), dev, torch.bfloat16)
    k, v = (_t(rng.standard_normal((b, nk, c)), dev, torch.bfloat16) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("b,nq,nk,heads", AB_HOPPER_SHAPES, ids=AB_HOPPER_IDS)
@pytest.mark.parametrize("variant", AB_FAMILY_NAMES)
def test_run_variant_hopper_body(dev, variant, b, nq, nk, heads):
    """Every K6 family at head dim 64 runs the Hopper body."""
    q, k, v = _ab_hopper_inputs(dev, b, nq, nk, heads * 64)
    before = run_variant.launches, run_variant.hopper_launches
    out = run_variant(variant, q, k, v, heads, 0.125)
    torch.cuda.synchronize()
    assert (run_variant.launches, run_variant.hopper_launches) == (before[0] + 1, before[1] + 1)
    _ab_close(variant, out, run_variant_plain(variant, q.float(), k.float(), v.float(), heads, 0.125))


@pytest.mark.parametrize("b,nq,nk,heads", AB_HOPPER_SHAPES, ids=AB_HOPPER_IDS)
@pytest.mark.parametrize("variant", ["bd", "bd_lmxu"])
def test_run_bd_hopper_body(dev, variant, b, nq, nk, heads):
    """K7: one work tile per 64 queries of a head pair, a consumer warpgroup
    per head."""
    q, k, v = _ab_hopper_inputs(dev, b, nq, nk, heads * 64)
    before = run_bd.launches, run_bd.hopper_launches, run_variant.launches
    out = run_variant(variant, q, k, v, heads, 0.125)
    torch.cuda.synchronize()
    assert (run_bd.launches, run_bd.hopper_launches, run_variant.launches) == (before[0] + 1, before[1] + 1, before[2])
    _ab_close(variant, out, run_variant_plain(variant, q.float(), k.float(), v.float(), heads, 0.125))


@pytest.mark.parametrize("variant", ["tr_max", "noexp", "pv_only", "bd"])
def test_ab_hopper_body_reads_strided_views(dev, variant):
    """k and v as channel views of one (B, N, 3C) tensor (row stride 3C),
    read in place by the Hopper entries."""
    rng = np.random.default_rng(15)
    q, k, v = _t(rng.standard_normal((2, 260, 3 * 256)), dev, torch.bfloat16).split(256, dim=-1)
    assert k.stride() == (260 * 768, 768, 1)
    out = run_variant(variant, q, k, v, 4, 0.125)
    torch.cuda.synchronize()
    _ab_close(variant, out, run_variant_plain(variant, q.float(), k.float(), v.float(), 4, 0.125))


def test_ab_hopper_body_rejects_unaligned_rows(dev):
    x = torch.randn(2, 140, 3 * 128 + 4, device=dev, dtype=torch.bfloat16)
    before = run_variant.launches, run_bd.launches
    for call in (lambda: run_variant("tr_max", x[..., :128], x[..., 128:256], x[..., 256:384], 2, 0.125),
                 lambda: run_bd(x[..., :128], x[..., 128:256], x[..., 256:384], 2, 0.125)):
        with pytest.raises(ValueError, match="strides"):
            call()
    torch.cuda.synchronize()
    assert (run_variant.launches, run_bd.launches) == before


@pytest.mark.parametrize("fam,pair", [("M1", False), ("M3", False), ("M3", True)])
def test_mma_sync_ab_entries_at_head_dim_64(dev, fam, pair):
    """The mma.sync entries that served K6/K7 at head dim 64 before the
    Hopper body (chip_smoke.py times them beside it) still compute their
    families."""
    from unidepth_tpu_torch.ops import _cuda
    from unidepth_tpu_torch.ops.kernel_ab import FAMILY_CODES, attention_ab_plain

    b, n, heads = 2, 333, 4
    q, k, v = _ab_inputs(dev, b, n, heads * 64)
    out = torch.empty_like(q)
    lib, stream = _cuda.library(), _cuda.stream_handle(q)
    if pair:
        err = lib.ud_attention_bd_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads, n, n, 0, stream)
    else:
        err = lib.ud_attention_ab_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads, n, n, 64,
                                      FAMILY_CODES[fam], stream)
    _cuda.check(err, fam)
    torch.cuda.synchronize()
    _ab_close(fam, out, attention_ab_plain(fam, q.float(), k.float(), v.float(), heads))


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


# ---- the Hopper body of K1 and K4 (attention_wgmma.cu: bf16, head dim 64) ----

HOPPER_K1_CASES = (
    [(1, n, 1) for n in (5, 64, 127, 128, 129, 1370, 4096)]
    + [(2, n, 4) for n in (5, 64, 127, 128, 129, 1370, 4096)]
    + [(8, 129, 16), (8, 1370, 16)]  # B * H = 128
    + [(8, 1453, 16)]  # the V1 ViT-L/14 encoder at 462 x 616: 33 x 44 patches + cls
)


def _hopper_counts():
    """The Hopper body's launches from K1, K4 and K3."""
    return flash_attention_qkv.hopper_launches, flash_attention_packed.hopper_launches, flash_attention.hopper_launches


def _plus_one(counts, i):
    return tuple(n + (j == i) for j, n in enumerate(counts))


@pytest.mark.parametrize("b,n,h", HOPPER_K1_CASES, ids=[f"b{b}-n{n}-h{h}" for b, n, h in HOPPER_K1_CASES])
def test_flash_attention_qkv_hopper_body(dev, b, n, h):
    """Ragged and exact key tiles (128 keys a tile, 128 queries a work tile),
    one to many work tiles a block of the persistent grid."""
    rng = np.random.default_rng(n + b)
    qkv = _t(rng.standard_normal((b, n, 3 * h * 64)), dev, torch.bfloat16)
    before = flash_attention_qkv.launches, _hopper_counts()
    out = flash_attention_qkv(qkv, h, 0.125)
    torch.cuda.synchronize()
    assert (flash_attention_qkv.launches, _hopper_counts()) == (before[0] + 1, _plus_one(before[1], 0))
    _close(out, flash_attention_qkv_plain(qkv.float(), h, 0.125), torch.bfloat16, 0)


def test_flash_attention_qkv_hopper_body_keeps_the_row_max(dev):
    """q and k x 10 give logits ~100: exp without the running row max
    overflows fp32 (e^89 > 3.4e38); the kernel must match the fp32 softmax.
    v keeps unit size, so the outputs do too and the bf16 gates apply as
    they are (bf16 p times v ~10 would be off by ~v / 2^9)."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 300, 3 * 128))
    x[..., :256] *= 10
    qkv = _t(x, dev, torch.bfloat16)
    ref = flash_attention_qkv_plain(qkv.float(), 2, 0.125)
    q, k, _ = qkv.float().view(2, 300, 3, 2, 64).unbind(2)
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * 0.125
    assert logits.abs().max() > 100
    before = _hopper_counts()
    out = flash_attention_qkv(qkv, 2, 0.125)
    torch.cuda.synchronize()
    assert _hopper_counts() == _plus_one(before, 0)
    assert torch.isfinite(out).all()
    _close(out, ref, torch.bfloat16, 0)


def _batch_strided(rng, b, n, width, dev):
    """(b, n, width) view of a (b, n + 3, width) tensor: batch stride (n + 3) * width."""
    return _t(rng.standard_normal((b, n + 3, width)), dev, torch.bfloat16)[:, :n]


@pytest.mark.parametrize(
    "b,nq,nk,c,layout",
    [
        (8, 1370, 1370, 1024, "views"),  # the int8 path: (8, 1370, 3 x 1024)
        (2, 70, 300, 256, "separate"),  # Nq != Nk
        (2, 300, 70, 256, "separate"),  # Nk < one key tile
        (1, 130, 130, 128, "views"),  # ragged tail
        (3, 200, 200, 256, "batch-strided"),  # batch stride (N + 3) * 3C, not N * 3C
    ],
    ids=["path", "nq70-nk300", "nq300-nk70", "ragged", "batch-strided"],
)
def test_flash_attention_packed_hopper_body(dev, b, nq, nk, c, layout):
    rng = np.random.default_rng(nq + nk + c)
    if layout == "views":
        q, k, v = _t(rng.standard_normal((b, nq, 3 * c)), dev, torch.bfloat16).split(c, dim=-1)
    elif layout == "batch-strided":
        q, k, v = _batch_strided(rng, b, nq, 3 * c, dev).split(c, dim=-1)
        assert q.stride(0) == (nq + 3) * 3 * c
    else:
        q = _t(rng.standard_normal((b, nq, c)), dev, torch.bfloat16)
        k, v = (_t(rng.standard_normal((b, nk, c)), dev, torch.bfloat16) for _ in range(2))
    h = c // 64
    before = flash_attention_packed.launches, flash_attention.launches, _hopper_counts()
    out = flash_attention_packed(q, k, v, h)
    torch.cuda.synchronize()
    assert (flash_attention_packed.launches, flash_attention.launches, _hopper_counts()) == (
        before[0] + 1, before[1], _plus_one(before[2], 1))
    _close(out, flash_attention_packed_plain(q.float(), k.float(), v.float(), h, 0.125), torch.bfloat16, 0)


def test_flash_attention_packed_hopper_body_keeps_the_row_max(dev):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 200, 3 * 128))
    x[..., :256] *= 10  # q and k: logits ~100; v unit size
    q, k, v = _t(x, dev, torch.bfloat16).split(128, dim=-1)
    logits = torch.einsum("bnhd,bmhd->bhnm", *(t.float().view(2, 200, 2, 64) for t in (q, k))) * 0.125
    assert logits.abs().max() > 100
    before = _hopper_counts()
    out = flash_attention_packed(q, k, v, 2)
    torch.cuda.synchronize()
    assert _hopper_counts() == _plus_one(before, 1)
    _close(out, flash_attention_packed_plain(q.float(), k.float(), v.float(), 2, 0.125), torch.bfloat16, 0)


@pytest.mark.parametrize("call", ["k3-fp32", "k1-fp32", "k4-fp32", "k1-bf16-d32"])
def test_other_attention_calls_leave_the_hopper_count(dev, call):
    """K1/K3/K4 in fp32 or at D != 64 launch attention.cu's bodies: their
    launch counts rise, no hopper_launches does."""
    rng = np.random.default_rng(12)
    before = _hopper_counts()
    if call == "k3-fp32":
        q, k, v = (_t(rng.standard_normal((4, 200, 64)), dev, torch.float32) for _ in range(3))
        n3 = flash_attention.launches
        out, ref = flash_attention(q, k, v, 0.125), flash_attention_plain(q, k, v, 0.125)
        assert flash_attention.launches == n3 + 1
        dtype = torch.float32
    elif call == "k4-fp32":
        q, k, v = _t(rng.standard_normal((2, 140, 3 * 128)), dev, torch.float32).split(128, dim=-1)
        out, ref = flash_attention_packed(q, k, v, 2), flash_attention_packed_plain(q, k, v, 2, 0.125)
        dtype = torch.float32
    else:
        dtype = torch.float32 if call == "k1-fp32" else torch.bfloat16
        h = 2 if call == "k1-fp32" else 4
        qkv = _t(rng.standard_normal((2, 140, 3 * 128)), dev, dtype)
        scale = (128 // h) ** -0.5
        out, ref = flash_attention_qkv(qkv, h, scale), flash_attention_qkv_plain(qkv.float(), h, scale)
    torch.cuda.synchronize()
    assert _hopper_counts() == before
    _close(out, ref, dtype, 1e-4)


K3_HOPPER_CASES = [
    (64, 1369, 1369),  # the V2 decoder's cross-attentions: 8 images x 8 heads
    (4, 1024, 1500),  # Nq != Nk
    (2, 300, 5000),  # past the TPU kernel's 4096 keys (it switches to blocked softmax there)
    (3, 200, 333),  # ragged last q tile and ragged last key tile together
    (2, 70, 4097),  # one ragged q tile; a last key tile of one key
    (64, 1452, 1452),  # the V1 decoder's layers_16 at B = 8: ViT-L/14's 33 x 44 grid
    (64, 1064, 1064),  # ConvNeXt-L's 28 x 38 grid
]


@pytest.mark.parametrize("bh,nq,nk", K3_HOPPER_CASES, ids=[f"bh{b}-nq{q}-nk{k}" for b, q, k in K3_HOPPER_CASES])
def test_flash_attention_hopper_body(dev, bh, nq, nk):
    """K3 in bf16 at D = 64 on the Hopper body: the flat (BH, N, 64) tensors
    as BH batches of one head."""
    rng = np.random.default_rng(bh + nq + nk)
    q = _t(rng.standard_normal((bh, nq, 64)), dev, torch.bfloat16)
    k, v = (_t(rng.standard_normal((bh, nk, 64)), dev, torch.bfloat16) for _ in range(2))
    before = flash_attention.launches, _hopper_counts()
    out = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert (flash_attention.launches, _hopper_counts()) == (before[0] + 1, _plus_one(before[1], 2))
    _close(out, flash_attention_plain(q.float(), k.float(), v.float(), 0.125), torch.bfloat16, 0)


def test_flash_attention_hopper_body_keeps_the_row_max(dev):
    """q and k x 10: logits ~100, past exp's fp32 range without the row max."""
    rng = np.random.default_rng(13)
    q, k = (_t(rng.standard_normal((4, 300, 64)) * 10, dev, torch.bfloat16) for _ in range(2))
    v = _t(rng.standard_normal((4, 300, 64)), dev, torch.bfloat16)
    assert (torch.einsum("bnd,bmd->bnm", q.float(), k.float()) * 0.125).abs().max() > 100
    before = _hopper_counts()
    out = flash_attention(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert _hopper_counts() == _plus_one(before, 2)
    assert torch.isfinite(out).all()
    _close(out, flash_attention_plain(q.float(), k.float(), v.float(), 0.125), torch.bfloat16, 0)


K3_NARROW_CASES = [
    (16, 1369, 1369, 48),  # the ViT-B/14 decoder at B = 2: 8 heads of 48, ragged Nk
    (64, 1369, 1369, 32),  # the ViT-S/14 decoder at B = 8: 8 heads of 32
    (4, 300, 1369, 48),  # Nq != Nk
    (4, 1024, 700, 32),
    (3, 200, 100, 48),  # Nk < one key tile
    (2, 70, 40, 32),
    (2, 130, 4097, 48),  # a last key tile of one key
]


@pytest.mark.parametrize("bh,nq,nk,d", K3_NARROW_CASES, ids=[f"bh{b}-nq{q}-nk{k}-d{d}" for b, q, k, d in K3_NARROW_CASES])
def test_flash_attention_hopper_body_at_head_dims_32_and_48(dev, bh, nq, nk, d):
    """K3 in bf16 at D = 32 and 48 on the Hopper body: 64-channel rows that
    TMA fills past D with zeros, stores clipped at D."""
    rng = np.random.default_rng(bh + nq + nk + d)
    q = _t(rng.standard_normal((bh, nq, d)), dev, torch.bfloat16)
    k, v = (_t(rng.standard_normal((bh, nk, d)), dev, torch.bfloat16) for _ in range(2))
    before = flash_attention.launches, _hopper_counts()
    out = flash_attention(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert (flash_attention.launches, _hopper_counts()) == (before[0] + 1, _plus_one(before[1], 2))
    _close(out, flash_attention_plain(q.float(), k.float(), v.float(), d**-0.5), torch.bfloat16, 0)


@pytest.mark.parametrize("d", [32, 48])
def test_flash_attention_hopper_body_keeps_the_row_max_at_head_dims_32_and_48(dev, d):
    """q and k x 10: logits ~100, past exp's fp32 range without the row max."""
    rng = np.random.default_rng(16 + d)
    q, k = (_t(rng.standard_normal((4, 300, d)) * 10, dev, torch.bfloat16) for _ in range(2))
    v = _t(rng.standard_normal((4, 300, d)), dev, torch.bfloat16)
    assert (torch.einsum("bnd,bmd->bnm", q.float(), k.float()) * d**-0.5).abs().max() > 100
    before = _hopper_counts()
    out = flash_attention(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert _hopper_counts() == _plus_one(before, 2)
    assert torch.isfinite(out).all()
    _close(out, flash_attention_plain(q.float(), k.float(), v.float(), d**-0.5), torch.bfloat16, 0)


# ---- K2's Hopper body (ln_dense_wgmma.cu: bf16, C % 64, C <= 2048, F % 256) ----

K2_HOPPER_CASES = [
    (10960, 1024, 4096, 1e-6, "gelu"),  # the ViT-L block at B=8, 518x518
    (1370, 1024, 4096, 1e-6, "gelu"),  # one image: ragged last row block (1370 = 10 x 128 + 90)
    (200, 1024, 4096, 1e-6, "gelu"),  # fewer tiles than SMs
    (1000, 256, 512, 1e-5, None),  # no activation, the decoder's eps
    (300, 192, 768, 1e-6, "gelu"),  # ConvNeXt's C = 192, F = 4C: an odd count of 64-deep slices
    (77, 64, 256, 1e-6, "gelu"),  # one slice, one tile
    # ConvNeXt-L's four stages at B = 8, 462 x 616 (141680 = 1106 x 128 + 112: a ragged last row block)
    (141680, 192, 768, 1e-6, "gelu"),
    (35112, 384, 1536, 1e-6, "gelu"),
    (8512, 768, 3072, 1e-6, "gelu"),
    (2128, 1536, 6144, 1e-6, "gelu"),  # 24 slices of 64 a tile, gamma and beta staged beside the ring
    # the V1 decoder's CvnxtBlocks at B = 8 (ViT-L/14 grid): C = 128 has two 64-deep slices a tile
    (185856, 128, 512, 1e-5, "gelu"),
    (46464, 256, 1024, 1e-5, "gelu"),
    (11616, 512, 2048, 1e-5, "gelu"),
]


@pytest.mark.parametrize("m,c,f,eps,act", K2_HOPPER_CASES, ids=[f"m{m}-c{c}-f{f}-{a}" for m, c, f, _, a in K2_HOPPER_CASES])
def test_ln_dense_hopper_body(dev, m, c, f, eps, act):
    rng = np.random.default_rng(m + c)
    x = _t(rng.standard_normal((m, c)) * 2 + 0.5, dev, torch.bfloat16)
    w = _t(rng.standard_normal((f, c)) / np.sqrt(c), dev, torch.bfloat16)
    b = _t(rng.standard_normal(f) * 0.1, dev, torch.float32)
    g = _t(1 + 0.1 * rng.standard_normal(c), dev, torch.float32)
    bt = _t(0.1 * rng.standard_normal(c), dev, torch.float32)
    before = ln_dense.launches, ln_dense.hopper_launches
    out = ln_dense(x, w, b, g, bt, eps, act)
    torch.cuda.synchronize()
    assert (ln_dense.launches, ln_dense.hopper_launches) == (before[0] + 1, before[1] + 1)
    _close(out, ln_dense_plain(x.float(), w.float(), b, g, bt, eps, act), torch.bfloat16, 0)


def test_ln_dense_hopper_body_normalises_before_the_product(dev):
    """Rows whose mean is ~50x their std: LN folded into the epilogue would
    subtract two products ~50x the result and lose its digits; normalising
    x before the product keeps the relative RMS gate."""
    rng = np.random.default_rng(14)
    m, c, f = 1370, 1024, 4096
    x = _t(rng.standard_normal((m, c)) + 50 * (1 + 0.1 * rng.standard_normal((m, 1))), dev, torch.bfloat16)
    mean, std = x.float().mean(-1), x.float().std(-1)
    assert (mean / std).min() > 20
    w = _t(rng.standard_normal((f, c)) / np.sqrt(c), dev, torch.bfloat16)
    b = _t(rng.standard_normal(f) * 0.1, dev, torch.bfloat16)
    g = _t(1 + 0.1 * rng.standard_normal(c), dev, torch.bfloat16)
    bt = _t(0.1 * rng.standard_normal(c), dev, torch.bfloat16)
    before = ln_dense.hopper_launches
    out = ln_dense(x, w, b, g, bt, 1e-6, "gelu")
    torch.cuda.synchronize()
    assert ln_dense.hopper_launches == before + 1
    _close(out, ln_dense_plain(x.float(), w.float(), b.float(), g.float(), bt.float(), 1e-6, "gelu"), torch.bfloat16, 0)


def test_from_config_defaults_to_the_card(dev):
    """No device named: the model lands on the card in bf16."""
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    cfg = {"model": {"name": "UniDepthV2", "num_heads": 2,
                     "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 1, 1]},
                     "pixel_encoder": {"name": "dinov2_vits14", "embed_dim": 128, "depth": 2, "num_heads": 2,
                                       "pos_embed_size": 8, "output_idx": [1, 1, 2, 2]}}}
    model = UniDepthV2.from_config(cfg)
    assert {(p.device.type, p.dtype) for p in model.parameters()} == {("cuda", torch.bfloat16)}


def test_vitb14_v2_infer_on_the_card(dev):
    """UniDepthV2 ViT-B/14 at 518x518: its encoder runs K1 and K2 on their
    Hopper bodies (C = 768, 12 heads of 64), its decoder's 4 camera-prompt
    cross-attentions K3 at head dim 48 on the Hopper body too; depth within
    the bf16 gate of the fp32 plain path."""
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / "config_v2_vitb14.json").read_text())
    rgb = np.random.default_rng(0).integers(0, 256, (1, 518, 518, 3), dtype=np.uint8)
    model = UniDepthV2.from_config(cfg).init_params(seed=0).eval()
    counted = (flash_attention_qkv, ln_dense, flash_attention, flash_attention_packed)
    for fn in counted:
        fn.launches = fn.hopper_launches = 0
    out = model.infer(rgb, outputs=("depth",))
    torch.cuda.synchronize()
    assert [(fn.launches, fn.hopper_launches) for fn in counted] == [(12, 12), (12, 12), (4, 4), (0, 0)]
    ref_model = UniDepthV2.from_config(cfg, device=dev, dtype=torch.float32).init_params(seed=0)
    ref = ref_model.set_kernels(False).eval().infer(rgb, outputs=("depth",))
    assert out["depth"].shape == ref["depth"].shape == (1, 518, 518, 1)
    assert torch.isfinite(out["depth"]).all() and (out["depth"] > 0).all()
    rel = ((out["depth"] - ref["depth"]).abs() / ref["depth"].abs()).flatten()
    assert rel.median().item() <= 1e-2


def test_vits14_v2_infer_on_the_card(dev):
    """UniDepthV2 ViT-S/14 at 518x518: K1 and K2 on their Hopper bodies (C =
    384, 6 heads of 64), the decoder's 4 cross-attentions K3 at head dim 32
    on the Hopper body; depth within the bf16 gate of the fp32 plain path."""
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / "config_v2_vits14.json").read_text())
    rgb = np.random.default_rng(0).integers(0, 256, (1, 518, 518, 3), dtype=np.uint8)
    model = UniDepthV2.from_config(cfg).init_params(seed=0).eval()
    counted = (flash_attention_qkv, ln_dense, flash_attention, flash_attention_packed)
    for fn in counted:
        fn.launches = fn.hopper_launches = 0
    out = model.infer(rgb, outputs=("depth",))
    torch.cuda.synchronize()
    assert [(fn.launches, fn.hopper_launches) for fn in counted] == [(12, 12), (12, 12), (4, 4), (0, 0)]
    ref_model = UniDepthV2.from_config(cfg, device=dev, dtype=torch.float32).init_params(seed=0)
    ref = ref_model.set_kernels(False).eval().infer(rgb, outputs=("depth",))
    assert out["depth"].shape == ref["depth"].shape == (1, 518, 518, 1)
    assert torch.isfinite(out["depth"]).all() and (out["depth"] > 0).all()
    rel = ((out["depth"] - ref["depth"]).abs() / ref["depth"].abs()).flatten()
    assert rel.median().item() <= 1e-2


V1_CASES = {
    # full widths, depth cut: ViT-L/14 with 4 blocks (K1 4, K2 4 + the decoder's 6 CvnxtBlocks, K3 3)
    "vitl14": ("config_v1_vitl14.json", {"depth": 4, "output_idx": [1, 2, 3, 4]}, [(4, 4), (10, 10), (3, 3), (0, 0)]),
    # ConvNeXt-L with depths (1, 1, 3, 1) (K2 6 + 6, K3 3 at ConvNeXt-L's 28 x 38 grid)
    "cnvnxtl": ("config_v1_cnvnxtl.json", {"depths": [1, 1, 3, 1]}, [(0, 0), (12, 12), (3, 3), (0, 0)]),
}


@pytest.mark.parametrize("name", list(V1_CASES))
def test_v1_infer_on_the_card(dev, name):
    """UniDepthV1 at full width with the encoder's depth cut, one 462 x 616
    image, from ``from_config`` with no device (the card, bf16): K1, K2 and
    K3 on their Hopper bodies at the V1 shapes, K4 never; depth within the
    V1 bf16 gate of the fp32 plain path (median relative error <= 8e-2,
    PERF.md section 2)."""
    from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1

    path, encoder, launches = V1_CASES[name]
    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / path).read_text())
    cfg["model"]["pixel_encoder"].update(encoder)
    rgb = np.random.default_rng(0).integers(0, 256, (1, 462, 616, 3), dtype=np.uint8)
    model = UniDepthV1.from_config(cfg).init_params(seed=0).eval()
    counted = (flash_attention_qkv, ln_dense, flash_attention, flash_attention_packed)
    for fn in counted:
        fn.launches = fn.hopper_launches = 0
    out = model.infer(rgb)
    torch.cuda.synchronize()
    assert [(fn.launches, fn.hopper_launches) for fn in counted] == launches
    ref = UniDepthV1.from_config(cfg, device=dev, dtype=torch.float32).init_params(seed=0).set_kernels(False).infer(rgb)
    assert out["depth"].shape == ref["depth"].shape == (1, 462, 616, 1)
    assert out["points"].shape == (1, 462, 616, 3) and out["intrinsics"].shape == (1, 3, 3)
    assert all(torch.isfinite(out[k]).all() for k in out) and (out["depth"] > 0).all()
    rel = ((out["depth"] - ref["depth"]).abs() / ref["depth"].abs()).flatten()
    assert rel.median().item() <= 8e-2


# the training path's shapes (UniDepthV2 ViT-L/14, B = 8 at 476 x 630: 34 x 45
# patches + cls = 1531 tokens): K1 on the (8, 1531, 3072) projection, K2 at M
# = 12248, K3 on the decoder's (64, 1530, 64); K4 at its int8 serving shape
TRAIN_GRAD_CASES = {
    "k1": lambda rng: ((rng.standard_normal((8, 1531, 3 * 1024)),), (16, 64**-0.5)),
    "k2": lambda rng: ((rng.standard_normal((8 * 1531, 1024)) * 2 + 0.5, rng.standard_normal((4096, 1024)) / 32,
                        rng.standard_normal(4096) * 0.1, 1 + 0.1 * rng.standard_normal(1024),
                        0.1 * rng.standard_normal(1024)), (1e-6, "gelu")),
    "k3": lambda rng: (tuple(rng.standard_normal((64, 1530, 64)) for _ in range(3)), (64**-0.5,)),
    "k4": lambda rng: (tuple(rng.standard_normal((8, 1370, 1024)) for _ in range(3)), (16, 64**-0.5)),
}
TRAIN_GRAD_FNS = {
    "k1": (flash_attention_qkv, flash_attention_qkv_plain),
    "k2": (ln_dense, ln_dense_plain),
    "k3": (flash_attention, flash_attention_plain),
    "k4": (flash_attention_packed, flash_attention_packed_plain),
}


@pytest.mark.parametrize("name", list(TRAIN_GRAD_CASES))
def test_kernel_gradient_matches_plain_autograd(dev, name):
    """The kernel route's gradients (bf16 inputs: the launch forward, the
    plain VJP backward in the plain version's dtypes) against the plain
    version's autograd in fp32 on the same bf16 inputs, at the bf16 gates
    with the elementwise atol scaled by max(1, max |ref|) (a gradient sums
    over rows: K2's weight over 12,248); the backward launches no kernel,
    and the forward took the Hopper body."""
    kernel, plain = TRAIN_GRAD_FNS[name]
    rng = np.random.default_rng(20)
    arrays, args = TRAIN_GRAD_CASES[name](rng)
    inputs = [_t(a, dev, torch.bfloat16).requires_grad_() for a in arrays]
    before = kernel.launches, kernel.hopper_launches
    out = kernel(*inputs, *args)
    assert (kernel.launches, kernel.hopper_launches) == (before[0] + 1, before[1] + 1)
    g = _t(rng.standard_normal(out.shape), dev, torch.bfloat16)
    grads = torch.autograd.grad(out, inputs, g)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.hopper_launches) == (before[0] + 1, before[1] + 1)
    ref_inputs = [t.detach().float().requires_grad_() for t in inputs]
    refs = torch.autograd.grad(plain(*ref_inputs, *args), ref_inputs, g.float())
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref, rtol=1.6e-2, atol=1e-2 * max(1.0, ref.abs().max().item()))
        assert ((got.float() - ref).norm() / ref.norm()).item() <= REL_RMS_BF16


def test_v2_train_step_on_the_card(dev):
    """UniDepthV2 at full ViT-L/14 width, the encoder cut to 4 blocks, one
    optimizer step of 2 micro-batches of 2 images (SelfDistill pairs them)
    at 448 x 448 (1024 tokens, so the decoder takes K3) from
    ``build_trainer`` with no device named: K1 and K2 4 + 4 (forward and
    recompute) a micro-batch, K3 4, all on their Hopper bodies; finite
    losses, the parameters moved."""
    from unidepth_tpu_torch.datasets.dummy import Dummy
    from unidepth_tpu_torch.datasets.loader import make_batch
    from unidepth_tpu_torch.training.trainer import build_trainer

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs" / "config_v2_vitl14.json").read_text())
    cfg["model"]["pixel_encoder"].update(depth=4, output_idx=[1, 2, 3, 4])
    trainer = build_trainer(cfg, seed=0)
    assert {(p.device.type, p.dtype) for p in trainer.model.parameters()} == {("cuda", torch.bfloat16)}
    batch = make_batch(Dummy(image_shape=(448, 448), length=8), 2, 2, np.random.default_rng(0))
    before = {n: p.clone() for n, p in trainer.state.params.items()}
    counted = (flash_attention_qkv, ln_dense, flash_attention, flash_attention_packed, conv3x3_lowchannel)
    for fn in counted:
        fn.launches = fn.hopper_launches = 0
    metrics = trainer.step(batch, 0)
    torch.cuda.synchronize()
    # the heads' hr tails stay on cuDNN under autograd: no K5
    assert [(fn.launches, fn.hopper_launches) for fn in counted] == [(16, 16), (16, 16), (8, 8), (0, 0), (0, 0)]
    assert all(torch.isfinite(v) for v in metrics.values())
    assert any(not torch.equal(p, before[n]) for n, p in trainer.state.params.items())

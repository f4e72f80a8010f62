"""K2h (``ops.head_mlp``): the V2 heads' LayerNorm -> Linear pair, both heads
in one launch from the NCHW latents.

On the CPU (tier-1): the plain version against the modules it replaces;
the C entry's arguments with the library stubbed (the latents' pointer as
they lie, each head's parameters, one launch counted), what the launch
refuses before the library is called; which calls ``DepthHead.heads``
routes to K2h (a "CUDA" bf16 map that needs no gradient, kernels on, plain
bf16 LayerNorm and Linear within the envelope) and which keep the modules
(the CPU, fp32, autograd, ``set_kernels(False)``, an int8 linear, another
width or grid); and that ``head_mlp.launches`` ticks once a decoder call.

On the card (marked ``cuda``, skipped without one; no JAX here):

    python -m pytest --noconftest -m cuda tests/test_torch_head_mlp.py -q

K2h per head against ``ln_dense_plain(..., activation=None)`` on the same
bf16 inputs at K2's bf16 gates (rtol 1.6e-2, atol 1e-2) and against the
plain version in fp32 at the relative RMS gate (5e-3), at the 518x518
latents, one camera's grid, a small odd batch and C = 64; the latents read
in place; one head equal to the first of two; a V2 ``infer()`` whose eager,
captured and replayed decoder calls agree bit for bit; ``DepthHead.heads``
with K2h and with the modules within the gates.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu_torch.models.unidepthv2 import decoder as decoder_mod
from unidepth_tpu_torch.models.unidepthv2.decoder import Decoder, DepthHead
from unidepth_tpu_torch.nn.layers import layer_norm
from unidepth_tpu_torch.ops import head_mlp as hm
from unidepth_tpu_torch.ops.fused_block import ln_dense_plain
from unidepth_tpu_torch.ops.quant import QuantLinear

ROOT = Path(__file__).resolve().parents[1]
ENTRY = "ud_head_mlp_hopper_fwd"
TOL_BF16 = dict(rtol=1.6e-2, atol=1e-2)
REL_RMS_BF16 = 5e-3


def _params(c, heads, seed, dtype=torch.float32):
    """Per head: weight (C, C), bias, gamma, beta and eps, drawn so every
    term moves the result."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(heads):
        out.append([(torch.randn(c, c, generator=g) * c**-0.5).to(dtype), (torch.randn(c, generator=g) * 0.1).to(dtype),
                    (1.0 + 0.1 * torch.randn(c, generator=g)).to(dtype), (0.1 * torch.randn(c, generator=g)).to(dtype)])
    weights, biases, gammas, betas = (list(t) for t in zip(*out))
    return weights, biases, gammas, betas, [1e-5] * heads


def _modules(weights, biases, gammas, betas, eps):
    mlps = []
    for w, b, g, bt, e in zip(weights, biases, gammas, betas, eps):
        c = w.shape[0]
        norm, linear = nn.LayerNorm(c, eps=e), nn.Linear(c, c)
        with torch.no_grad():
            norm.weight.copy_(g), norm.bias.copy_(bt), linear.weight.copy_(w), linear.bias.copy_(b)
        mlps.append(nn.Sequential(norm, linear).to(w.dtype))
    return mlps


# ---- the plain version --------------------------------------------------------------

@pytest.mark.parametrize("c,heads", [(64, 2), (128, 2), (128, 1)])
def test_head_mlp_plain_matches_the_modules(c, heads):
    """fp32 on the CPU: ``head_mlp`` (its plain version) equals each head's
    ``linear(layer_norm(norm, latents NHWC))`` and launches nothing."""
    params = _params(c, heads, seed=c + heads)
    x = torch.randn(2, c, 8, 24) * 2.0 + 0.5
    before = hm.head_mlp.launches
    got = hm.head_mlp(x, *params)
    assert hm.head_mlp.launches == before and len(got) == heads
    for y, (norm, linear) in zip(got, _modules(*params)):
        assert y.shape == (2, 8, 24, c)
        torch.testing.assert_close(y, linear(layer_norm(norm, x.permute(0, 2, 3, 1))), rtol=1e-5, atol=1e-5)


# ---- the launch, the library stubbed --------------------------------------------------

class _EntryRecorder:
    def __init__(self):
        self.calls, self.args = [], []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append(entry) or self.args.append(args) or 0


@pytest.fixture
def stub_library(monkeypatch):
    from unidepth_tpu_torch.ops import _cuda

    lib = _EntryRecorder()
    monkeypatch.setattr(_cuda, "library", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    return lib


@pytest.mark.parametrize("heads", [2, 1])
def test_k2h_passes_the_latents_in_place_and_each_heads_parameters(stub_library, heads):
    """bf16 latents (B, C, H, W) go to ``ud_head_mlp_hopper_fwd`` as they lie
    (no copy), with each head's weight, bias, gamma, beta, output and eps
    (head 1's pointers None for one head); one launch is counted."""
    weights, biases, gammas, betas, eps = _params(128, heads, seed=3, dtype=torch.bfloat16)
    eps = [1e-5, 1e-6][:heads]
    x = torch.zeros(3, 128, 8, 24, dtype=torch.bfloat16)
    before = hm.head_mlp.launches
    outs = hm._launch(x, weights, biases, gammas, betas, eps)
    assert hm.head_mlp.launches == before + 1 and stub_library.calls == [ENTRY]
    assert len(outs) == heads and all(o.shape == (3, 8, 24, 128) and o.dtype == torch.bfloat16 for o in outs)
    (args,) = stub_library.args

    def two(ts):
        return [t.data_ptr() for t in ts] + [None] * (2 - heads)

    assert list(args[:11]) == [x.data_ptr(), *two(weights), *two(biases), *two(gammas), *two(betas), *two(outs)]
    assert args[11:] == (3, 128, 8 * 24, heads, *[pytest.approx(e) for e in eps], *[0.0] * (2 - heads), 0)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


# name: (x, per-head parameters, grad) the launch refuses
REFUSED = {
    "fp32": lambda: (torch.zeros(1, 128, 8, 8), _params(128, 2, 0), False),
    "c96": lambda: (_bf16(1, 96, 8, 8), _params(96, 2, 0, torch.bfloat16), False),
    "grid-not-64": lambda: (_bf16(1, 128, 6, 10), _params(128, 2, 0, torch.bfloat16), False),
    "three-heads": lambda: (_bf16(1, 128, 8, 8), _params(128, 3, 0, torch.bfloat16), False),
    "weight-shape": lambda: (_bf16(1, 64, 8, 8), ([_bf16(128, 64)] * 2, *_params(64, 2, 0, torch.bfloat16)[1:]), False),
    "needs-grad": lambda: (_bf16(1, 128, 8, 8).requires_grad_(), _params(128, 2, 0, torch.bfloat16), True),
    "misaligned": lambda: (torch.zeros(1 + 128 * 64, dtype=torch.bfloat16)[1:].view(1, 128, 8, 8),
                           _params(128, 2, 0, torch.bfloat16), False),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_k2h_raises_off_its_envelope(stub_library, case):
    x, params, grad = REFUSED[case]()
    before = hm.head_mlp.launches
    with torch.set_grad_enabled(grad), pytest.raises(ValueError):
        hm._launch(x, *params)
    assert stub_library.calls == [] and hm.head_mlp.launches == before


# ---- the route in DepthHead.heads -------------------------------------------------------

@pytest.fixture
def k2h_calls(monkeypatch):
    """CPU tensors read as CUDA ones to the decoder's routes (``is_cuda``);
    ``head_mlp`` records each call's head count, checks it gets the NCHW
    latents as they lie, then runs its plain version."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    calls = []

    def recorded(x, weights, *args):
        calls.append(len(weights))
        assert x.is_contiguous()  # the pyramid's NCHW output, read in place
        return hm.head_mlp_plain(x, weights, *args)

    monkeypatch.setattr(decoder_mod, "head_mlp", recorded)
    return calls


def _int8_confidence(head):
    linear = head.confidence_mlp[1]
    head.confidence_mlp[1] = QuantLinear.from_float(linear.weight.float(), linear.bias.float())


# case: (dtype, kernels on, grad enabled, confidence, out_dim, latents' grid, change, K2h heads per call)
ROUTES = {
    "bf16-serving": (torch.bfloat16, True, False, True, 64, (12, 16), None, [2]),
    "bf16-depth-only": (torch.bfloat16, True, False, False, 64, (12, 16), None, [1]),
    "fp32": (torch.float32, True, False, True, 64, (12, 16), None, []),
    "bf16-autograd": (torch.bfloat16, True, True, True, 64, (12, 16), None, []),
    "bf16-kernels-off": (torch.bfloat16, False, False, True, 64, (12, 16), None, []),
    "bf16-int8-linear": (torch.bfloat16, True, False, True, 64, (12, 16), _int8_confidence, []),
    "bf16-c32": (torch.bfloat16, True, False, True, 32, (12, 16), None, []),
    "bf16-grid-not-64": (torch.bfloat16, True, False, True, 64, (12, 15), None, []),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_depth_head_routes_the_mlps(k2h_calls, case):
    """``DepthHead.heads`` sends both heads' MLPs (or the depth head's alone)
    to one K2h call for a "CUDA" bf16 map that needs no gradient, with
    kernels on, plain bf16 modules and a width and grid in the envelope;
    every other call keeps the modules. The K2h route's output is the
    modules' within bf16 rounding."""
    dtype, kernels, grad, confidence, out_dim, grid, change, want = ROUTES[case]
    torch.manual_seed(0)
    head = DepthHead(64, num_heads=2, depths=(1, 1, 1), out_dim=out_dim).to(dtype)
    if change is not None:
        change(head)
    head.use_kernels = kernels
    latents = torch.randn(2, head.confidence_mlp[0].normalized_shape[0], *grid, dtype=dtype)
    with torch.set_grad_enabled(grad):
        out = head.heads(latents, (30, 70), confidence)
    assert k2h_calls == want
    assert out[0].shape == (2, 1, 30, 70) and (out[1] is not None) == confidence
    if want:
        head.use_kernels = False
        with torch.no_grad():
            ref = head.heads(latents, (30, 70), confidence)
        for a, b in zip(out, ref):
            if b is not None:
                torch.testing.assert_close(a.float(), b.float(), rtol=1.6e-2, atol=1.6e-2)


@pytest.mark.parametrize("k2h", [True, False], ids=["k2h", "modules"])
def test_heads_free_the_latents_once_k2h_has_read_them(k2h_calls, monkeypatch, k2h):
    """Handed over as ``heads()``'s only reference (as ``Decoder._forward``
    does), the latents are freed before either head's lr conv on K2h's
    route, so its second output takes their place in memory; the modules
    read them for each head, as before."""
    import weakref

    head = DepthHead(64, num_heads=2, depths=(1, 1, 1), out_dim=64).to(torch.bfloat16)
    head.use_kernels = k2h
    latents = [torch.randn(2, 64, 12, 16, dtype=torch.bfloat16)]
    ref, alive = weakref.ref(latents[0]), []
    run = head._head
    monkeypatch.setattr(head, "_head", lambda *a: alive.append(ref() is not None) or run(*a))
    with torch.no_grad():
        head.heads(latents.pop(), (30, 70))
    assert alive == [not k2h] * 2 and k2h_calls == [2] * k2h


def test_depth_head_on_the_cpu_keeps_the_modules(monkeypatch):
    calls = []
    monkeypatch.setattr(decoder_mod, "head_mlp", lambda *a: calls.append(a))
    head = DepthHead(64, num_heads=2, depths=(1, 1, 1), out_dim=64).to(torch.bfloat16)
    with torch.no_grad():
        head.heads(torch.randn(1, 64, 8, 8, dtype=torch.bfloat16), (20, 20))
    assert calls == []


def test_head_mlp_launches_tick_once_a_decoder_call(stub_library, monkeypatch):
    """A bf16 decoder forward that needs no gradient launches K2h once for
    both heads (the library stubbed: the launch is counted, the plain
    version gives the values the rest of the decoder reads)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))

    def launch_then_plain(*args):
        hm._launch(*args)
        return hm.head_mlp_plain(*args)

    monkeypatch.setattr(decoder_mod, "head_mlp", launch_then_plain)
    torch.manual_seed(1)
    dec = Decoder((32,) * 4, 256, num_heads=2, depths=(1, 1, 1), out_dim=32).to(torch.bfloat16).eval()  # C = 64
    b, gh, gw = 1, 2, 3
    feats = [torch.randn(b, gh, gw, 32, dtype=torch.bfloat16) for _ in range(4)]
    cls = [torch.randn(b, 1, 32, dtype=torch.bfloat16) for _ in range(4)]
    before = hm.head_mlp.launches
    with torch.no_grad():
        out = dec(feats, cls, (14 * gh, 14 * gw))
    assert hm.head_mlp.launches == before + 1 and stub_library.calls == [ENTRY]
    assert out["radius"].shape == (b, 14 * gh, 14 * gw, 1) and torch.isfinite(out["confidence"]).all()
    with torch.no_grad():
        dec(feats, cls, (14 * gh, 14 * gw), confidence=False)
    assert hm.head_mlp.launches == before + 2


# ---- the card -----------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(shape, heads, seed, dev):
    b, c, h, w = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
    return x, [[t.to(dev) for t in ts] for ts in _params(c, heads, seed, torch.bfloat16)[:4]] + [[1e-5] * heads]


def _check_heads(outs, x, params):
    """Each head at the bf16 gates: elementwise against ``ln_dense_plain`` on
    the same bf16 inputs (rounding where the kernel rounds), relative RMS
    against it in fp32."""
    xh = x.permute(0, 2, 3, 1)
    for out, (w, b, g, bt, e) in zip(outs, zip(*params)):
        torch.testing.assert_close(out.float(), ln_dense_plain(xh, w, b, g, bt, e).float(), **TOL_BF16)
        ref = ln_dense_plain(xh.float(), w.float(), b.float(), g.float(), bt.float(), e)
        assert ((out.float() - ref).norm() / ref.norm()).item() <= REL_RMS_BF16


# (B, C, H, W): the 518x518 latents, the 1080x1920 camera's (588 x 1036 in the network), a small odd batch, C = 64
CARD_SHAPES = [(8, 128, 296, 296), (8, 128, 336, 592), (3, 128, 24, 40), (3, 64, 56, 72)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["x".join(map(str, s)) for s in CARD_SHAPES])
def test_head_mlp_matches_plain(dev, shape):
    x, params = _card_inputs(shape, 2, seed=sum(shape), dev=dev)
    before = hm.head_mlp.launches
    outs = hm.head_mlp(x, *params)
    torch.cuda.synchronize()
    assert hm.head_mlp.launches == before + 1
    assert all(o.shape == (shape[0], *shape[2:], shape[1]) and o.is_contiguous() for o in outs)
    _check_heads(outs, x, params)


@pytest.mark.cuda
def test_head_mlp_reads_the_latents_in_place(dev, monkeypatch):
    """The kernel gets the NCHW latents' own pointer: no copy before it."""
    from unidepth_tpu_torch.ops import _cuda

    lib, seen = _cuda.library(), []

    class Spy:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            return (lambda *a: seen.append(a[0]) or fn(*a)) if name == ENTRY else fn

    monkeypatch.setattr(_cuda, "library", lambda: Spy())
    x, params = _card_inputs((2, 128, 40, 64), 2, seed=5, dev=dev)
    allocated = torch.cuda.memory_allocated(dev)
    outs = hm.head_mlp(x, *params)
    torch.cuda.synchronize()
    assert seen == [x.data_ptr()]
    assert torch.cuda.memory_allocated(dev) - allocated == sum(o.numel() * o.element_size() for o in outs)
    _check_heads(outs, x, params)


@pytest.mark.cuda
def test_one_head_is_the_first_of_two(dev):
    x, params = _card_inputs((3, 128, 24, 40), 2, seed=7, dev=dev)
    both = hm.head_mlp(x, *params)
    (one,) = hm.head_mlp(x, *[p[:1] for p in params])
    torch.cuda.synchronize()
    assert torch.equal(one, both[0])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vits14", "vitl14"])
def test_infer_replays_k2h_bit_for_bit(dev, name):
    """V2 ``infer()``: the eager decoder call and its capture launch K2h once
    each, the replay none; captured and replayed outputs equal the eager
    call's bit for bit."""
    from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

    cfg = json.loads((ROOT / "configs" / f"config_v2_{name}.json").read_text())
    m = UniDepthV2.from_config(cfg, device=dev).init_params(seed=0).eval()
    rgb = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 518, 518, 3), dtype=np.uint8))
    launches = []
    outs = []
    for _ in range(3):  # eager, captured, replayed
        before = hm.head_mlp.launches
        outs.append({k: v.clone() for k, v in m.infer(rgb).items() if torch.is_tensor(v)})
        torch.cuda.synchronize()
        launches.append(hm.head_mlp.launches - before)
    assert launches == [1, 1, 0]
    for out in outs[1:]:
        assert all(torch.equal(out[k], outs[0][k]) for k in outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,latents", [(512, (2, 128, 296, 296)), (256, (2, 64, 112, 160))])
def test_depth_head_with_and_without_k2h(dev, hidden, latents, monkeypatch):
    """``DepthHead.heads`` on bf16 latents at the ViT-L and ViT-S widths: one
    K2h launch, and the same call with the MLPs on their modules (every
    other kernel as it was), within the bf16 gates (the elementwise atol
    scaled by max(1, max |ref|) as K5's head: the lr conv sums 9 C rounded
    MLP outputs)."""
    torch.manual_seed(0)
    out_dim = 64 if hidden == 512 else 32
    head = DepthHead(hidden, num_heads=8, depths=(2, 2, 2), out_dim=out_dim).to(dev, torch.bfloat16).eval()
    x = (torch.randn(latents, device=dev) * 2.0 + 0.5).to(torch.bfloat16)
    shape = (latents[2] * 7 // 4, latents[3] * 7 // 4)
    with torch.no_grad():
        before = hm.head_mlp.launches
        got = head.heads(x, shape)
        assert hm.head_mlp.launches == before + 1
        monkeypatch.setattr(head, "_mlps_on_k2h", lambda *a: False)
        ref = head.heads(x, shape)
        assert hm.head_mlp.launches == before + 1
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        b = b.float()
        torch.testing.assert_close(a.float(), b, rtol=1.6e-2, atol=1e-2 * max(1.0, b.abs().max().item()))
        assert ((a.float() - b).norm() / b.norm()).item() <= REL_RMS_BF16

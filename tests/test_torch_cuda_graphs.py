"""V2's and V1's ``infer()`` stage graphs (``models/stage_graphs.py``) and
the constants they build once instead of on every call.

On the CPU (tier-1): the route runs eagerly on the CPU, under autograd and
under export, and counts why; the key separates ``confidence``, ``rays_gt``
and the input dtype (V2), ``rays_gt``, ``K_gt`` and ``skip_camera`` (V1);
each cached constant equals its per-call construction bit for bit; and,
with a stand-in for the CUDA graph that replays by running the captured
stage again over the static buffers, on a tiny V2 (ViT) and a tiny V1
(ConvNeXt): the static buffers' bookkeeping: the counters, replays equal to
the eager call bit for bit, a new image's own result, returned tensors that
a later call leaves alone, the buffers grown once for four shapes (V1: four
batch sizes, its network shape being fixed), threads that share a model,
the graphs dropped by ``set_kernels`` and a cast, and a warm ``infer()``
that reads no tensor back to the host.

On the card (marked ``cuda``, skipped without one; no JAX here):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py -q

the real graphs: a replayed ``infer()`` equals the eager first call bit for
bit at 518x518 and at a padded 375x1242, at ViT-S/14 and at ViT-L/14, and
under int8 serving; V1 ConvNeXt-L and V1 ViT-L/14 at B = 8 into 462x616, with
and without a given K, replay bit for bit and make the host wait on nothing
once warm, and the ConvNeXt-L cell of the benchmark is correct at its limits
on one seed; a replay with a new image gives that image's eager
result; a returned tensor
is unchanged by a later call of another shape; a warm call makes the host
wait on nothing (``torch.cuda.set_sync_debug_mode("error")``); four warmed
shapes leave no more memory allocated than the static buffers of the
largest; ``encode_decode`` and a forward under autograd never replay.
"""

import contextlib
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu_torch.models import stage_graphs
from unidepth_tpu_torch.models.unidepthv1 import decoder as v1_decoder
from unidepth_tpu_torch.models.unidepthv1 import model as v1_model
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.models.unidepthv2 import model as v2_model
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.ops import fourier, resize as resize_mod

ROOT = Path(__file__).resolve().parents[1]
CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2, "expansion": 4, "layer_scale": 1.0,
        "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 1, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 128, "depth": 4, "num_heads": 2,
            "pos_embed_size": 8, "output_idx": [1, 2, 3, 4], "use_norm": True,
        },
    },
    "data": {"augmentations": {"shape_constraints": {
        "ratio_bounds": [0.5, 2.5], "pixels_min": 4000, "pixels_max": 10000}}},
}
V1_CFG = {
    "model": {
        "name": "UniDepthV1", "num_heads": 4, "expansion": 4,
        "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
        "pixel_encoder": {"name": "convnext_large", "depths": [1, 1, 2, 1], "dims": [32, 64, 128, 256]},
    },
    "data": {"image_shape": [64, 96]},
}
K = np.array([[80.0, 0, 45.0], [0, 85.0, 30.0], [0, 0, 1]], np.float32)

# resolution_level is left unset: infer() warns and takes the default budget
pytestmark = pytest.mark.filterwarnings("ignore:resolution_level not set")


def _rgb(seed, shape=(2, 60, 90, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _counts():
    return stage_graphs.call.captures, stage_graphs.call.replays, dict(stage_graphs.call.eager)


def _delta(before):
    captures, replays, eager = _counts()
    return captures - before[0], replays - before[1], {k: v - before[2].get(k, 0) for k, v in eager.items()
                                                        if v != before[2].get(k, 0)}


@pytest.fixture(scope="module")
def model():
    return UniDepthV2.from_config(CFG, device="cpu").init_params(seed=0).eval()


@pytest.fixture(scope="module")
def v1():
    return UniDepthV1.from_config(V1_CFG, device="cpu").init_params(seed=0).eval()


@pytest.fixture(params=["v2", "v1"])
def served(request, model, v1):
    """A copy of the tiny V2 or the tiny V1, for a test that changes it."""
    return copy.deepcopy(model if request.param == "v2" else v1)


def _infer(m, rgb, camera=None):
    return m.infer(rgb, camera=camera) if isinstance(m, UniDepthV2) else m.infer(rgb, intrinsics=camera)


def _network_shape(m, image_hw, has_camera=False):
    return m.serving_shape_key(image_hw, has_camera)[4] if isinstance(m, UniDepthV2) else m.image_shape


# ----------------------------------------------------------------------------
# the CPU
# ----------------------------------------------------------------------------
def test_route_is_eager_on_the_cpu_under_grad_and_export(model):
    before = _counts()
    model.infer(_rgb(0))
    assert _delta(before) == (0, 0, {"cpu": 2})  # the encoder and the decoder

    image = torch.zeros(1, 56, 84, 3)
    before = _counts()
    model.encode_decode(image)  # outside serving: no route at all
    assert _delta(before) == (0, 0, {})
    with stage_graphs.serving(model._stage_graphs), torch.enable_grad():
        model.encode_decode(image)
    assert _delta(before) == (0, 0, {"grad": 2})

    class Forward(torch.nn.Module):
        def forward(self, x):
            with stage_graphs.serving(model._stage_graphs), torch.no_grad():
                return model.pixel_encoder(x)[0][0]

    before = _counts()
    torch.export.export(Forward(), (image,))
    assert _delta(before)[:2] == (0, 0) and _delta(before)[2].keys() == {"export"}


@pytest.mark.parametrize("family", ["v2", "v1"])
def test_key_separates_confidence_rays_and_dtype(family):
    def key(*args):
        return stage_graphs._flatten(args, [])

    feats = [torch.zeros(2, 4, 6, 8)] * 4
    cls = [torch.zeros(2, 1, 8)] * 4
    rays = torch.zeros(2, 56 * 84, 3)
    if family == "v2":
        base = key(feats, cls, (56, 84), None, True)
        assert base == key([t.clone() for t in feats], cls, (56, 84), None, True)  # values do not count
        assert len({base, key(feats, cls, (56, 84), None, False), key(feats, cls, (56, 84), rays, True),
                    key([t.bfloat16() for t in feats], cls, (56, 84), None, True),
                    key(feats, cls, (56, 70), None, True)}) == 5
    else:  # V1's decoder: (features, cls_tokens, image_shape, rays_gt, skip_camera, K_gt)
        K_gt = torch.zeros(2, 3, 3)
        base = key(feats, cls, (56, 84), None, False, None)
        assert base == key([t.clone() for t in feats], cls, (56, 84), None, False, None)
        assert len({base, key(feats, cls, (56, 84), rays, False, K_gt), key(feats, cls, (56, 84), rays, True, K_gt),
                    key(feats, cls, (56, 84), rays, False, None), key(feats, cls, (56, 84), None, True, None),
                    key([t.bfloat16() for t in feats], cls, (56, 84), None, False, None),
                    key(feats, cls, (56, 70), None, False, None)}) == 7
    x = torch.zeros(2, 56, 84, 3)
    assert key(x) != key(x.bfloat16()) and key(x) != key(x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3))


def test_cached_constants_equal_their_per_call_construction():
    from unidepth_tpu_torch.utils.constants import IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD

    cpu = torch.device("cpu")
    mean, std = v2_model._imagenet_scale(cpu)
    assert torch.equal(mean, torch.tensor(IMAGENET_DATASET_MEAN, device=cpu) * 255.0)
    assert torch.equal(std, torch.tensor(IMAGENET_DATASET_STD, device=cpu) * 255.0)
    assert v2_model._imagenet_scale(cpu)[0] is mean  # built once

    for factor in (1.0, 0.7389162561576355, 1.2527472527472527):
        inv = 1.0 / factor
        want = torch.tensor([[inv, 1.0, inv], [1.0, inv, inv], [1.0, 1.0, 1.0]], device=cpu)
        assert torch.equal(v2_model._descale(factor, cpu), want)

    for num_bands, max_freq, use_log, dtype in ((256, 18, True, torch.float32), (64, 7, False, torch.float64)):
        if use_log:
            want = 2.0 ** np.linspace(0.0, np.log2(max_freq), num=num_bands)
        else:
            want = np.linspace(1.0, max_freq / 2, num=num_bands)
        want = torch.as_tensor(want * np.pi, dtype=dtype)
        got = fourier._scales(num_bands, max_freq, use_log, dtype, cpu)
        assert got.dtype == dtype and torch.equal(got, want)
        assert not got.is_inference()  # usable where autograd records

    for n, m, exact in ((30, 29, True), (37, 74, False)):
        assert torch.equal(resize_mod._on(resize_mod._nearest_index, n, m, exact, device=cpu),
                           torch.as_tensor(resize_mod._nearest_index(n, m, exact)))
    want = torch.as_tensor(resize_mod._bicubic_matrix(37, 42, 42.1 / 37), dtype=torch.float32)
    assert torch.equal(resize_mod._on(resize_mod._bicubic_matrix, 37, 42, 42.1 / 37, dtype=torch.float32,
                                      device=cpu), want)

    # V1: the input's divisors and shifts, K to and from the network shape, the sine grid
    c255, c1, imagenet, identity = v1_model._input_scales(cpu)
    assert torch.equal(c255, torch.tensor(255.0)) and torch.equal(c1, torch.tensor(1.0))
    assert torch.equal(imagenet, torch.tensor([IMAGENET_DATASET_MEAN, IMAGENET_DATASET_STD]))
    assert torch.equal(identity, torch.tensor([[0.0] * 3, [1.0] * 3]))
    assert v1_model._input_scales(cpu)[2] is imagenet
    for ratio, pl, pt in ((1.0, 0, 0), (0.616, 0, 35), (1.4372093023255814, 12, 0)):
        inv = 1.0 / ratio
        want = (torch.tensor([[ratio, 1.0, ratio], [1.0, ratio, ratio], [1.0, 1.0, 1.0]]),
                torch.tensor([[0.0, 0.0, pl], [0.0, 0.0, pt], [0.0, 0.0, 0.0]]),
                torch.tensor([[inv, 1.0, inv], [1.0, inv, inv], [1.0, 1.0, 1.0]]),
                torch.tensor([[0.0, 0.0, pl * inv], [0.0, 0.0, pt * inv], [0.0, 0.0, 0.0]]))
        got = v1_model._k_maps(ratio, pl, pt, cpu)
        assert all(g.dtype == torch.float32 and torch.equal(g, w) for g, w in zip(got, want))
    for h, w, hidden in ((29, 38, 512), (4, 6, 32)):
        want = fourier.position_embedding_sine(h, w, num_pos_feats=hidden // 2, normalize=True).reshape(h * w, hidden)
        assert torch.equal(v1_decoder._sine_grid(h, w, hidden, cpu), want)


def test_profile_serve_counts_kernels_by_their_device_operations():
    import importlib.util

    spec = importlib.util.spec_from_file_location("profile_serve", ROOT / "scripts_torch" / "profile_serve.py")
    profile_serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile_serve)
    ops = {"unidepth.infer.encoder: void attn_fwd_wgmma<1, 16, 2, 64>(CUtensorMap, CUtensorMap)": 24,
           "unidepth.infer.encoder: ln_row_stats(__nv_bfloat16 const*, float2*, int, int, float)": 24,
           "unidepth.infer.encoder: ln_dense_wgmma(CUtensorMap, CUtensorMap, CUtensorMap)": 24,
           "unidepth.infer.encoder: ln_swiglu_wgmma(CUtensorMap, CUtensorMap, CUtensorMap)": 3,
           "unidepth.infer.decoder: void attn_fwd_wgmma<0, 8, 2, 64>(CUtensorMap, CUtensorMap)": 4,
           "unidepth.infer.decoder: void conv3x3_wgmma<32, 3>(CUtensorMap, CUtensorMap)": 2,
           "unidepth.infer.decoder: void (anonymous namespace)::head_mlp_wgmma<128>(CUtensorMap, CUtensorMap)": 1,
           "unidepth.infer.decoder: void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16>(Params)": 40,
           "unidepth.infer.encoder: conv2d_c1_k1_nhwc_specialized": 36,
           "unidepth.infer.decoder: conv2d_c1_k1_nhwc_specialized": 6,
           "unidepth.infer.decoder: void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true>(int)": 3}
    assert profile_serve.kernel_ops(ops) == {"K1": 24, "K2": 24, "K2g": 3, "K2h": 1, "K3": 4, "K4": 0, "K5": 2,
                                             "dwconv": 42}
    assert profile_serve.kernel_ops(ops, int8=True)["K4"] == 24


def test_a_trace_builds_its_own_constants():
    """Built under ``torch.export`` (fake tensors), a constant is the
    trace's and is not kept: exports and later calls each get a real one."""

    class Embed(torch.nn.Module):
        def forward(self, x):
            return fourier.generate_fourier_features(x, dim=16, max_freq=9, use_log=True)

    fourier._scales.cache_clear()
    x = torch.rand(2, 5, 2)
    for _ in range(2):
        torch.export.export(Embed(), (x,))
    want = torch.as_tensor(2.0 ** np.linspace(0.0, np.log2(9), num=8) * np.pi, dtype=torch.float32)
    assert torch.equal(fourier._scales(8, 9, True, torch.float32, torch.device("cpu")), want)
    assert torch.equal(Embed()(x), torch.export.export(Embed(), (x,)).module()(x))


class _Graph:
    """The CUDA graph's stand-in: capturing records the entry whose body
    runs (``stage_graphs._body``); a replay runs that body again, over the
    static buffers, as the graph would."""

    capturing = None

    def capture_begin(self, pool=None, capture_error_mode="global"):
        _Graph.capturing = self

    def capture_end(self):
        _Graph.capturing = None

    def replay(self):
        stage_graphs._body(self.entry)


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The route taken on the CPU, into ``_Graph``."""
    real_body = stage_graphs._body

    def body(entry):
        if _Graph.capturing is not None:
            _Graph.capturing.entry = entry
        real_body(entry)

    def eager_reason(leaves):
        return "grad" if torch.is_grad_enabled() else None

    monkeypatch.setattr(stage_graphs, "_body", body)
    monkeypatch.setattr(stage_graphs, "_eager_reason", eager_reason)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].stride() == b[k].stride(), k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("camera", [None, K], ids=["predicted-camera", "given-K"])
def test_replays_equal_the_eager_call_and_own_their_outputs(served, cpu_graphs, camera):
    m = served
    a, b = _rgb(1), _rgb(2)
    before = _counts()
    eager_a = _infer(m, a, camera)
    assert _delta(before) == (0, 0, {"first sight": 2})
    captured = _infer(m, a, camera)
    assert _delta(before) == (2, 2, {"first sight": 2})
    _equal(captured, eager_a)
    replayed_b = _infer(m, b, camera)
    replayed_a = _infer(m, a, camera)
    assert _delta(before) == (2, 6, {"first sight": 2})
    _equal(replayed_a, eager_a)
    _equal(captured, eager_a)  # the tensors returned before are the caller's own
    if camera is not None:  # the given rays (and V1's K) are read where they were copied in
        h, w = _network_shape(m, a.shape[1:3], True)
        got = sorted(v.numel() for k, v in m._stage_graphs.buffers.items() if k[0] is m.pixel_decoder and k[1] == "in")
        want = [2 * h * w * 3 * 4] + ([2 * 9 * 4] if isinstance(m, UniDepthV1) else [])
        assert got == sorted(-(-n // 16) * 16 for n in want)
    m._stage_graphs.clear()
    _equal(replayed_b, _infer(m, b, camera))  # b's eager result


def _encoder_buffer_bytes(m, batch, h, w) -> list:
    """The encoder's output buffers at (batch, h, w): V2's four stage outputs,
    a feature map and a cls token each; V1's four ConvNeXt stage maps, then
    its four tokens."""
    if isinstance(m, UniDepthV2):
        return [batch * (h // 14 * w // 14 + 1) * 128 * 4] * 4
    cfg = m.pixel_encoder.cfg
    maps = [batch * (h // 4 >> s) * (w // 4 >> s) * c * 4 for s, c in enumerate(cfg.dims)]
    return maps + [batch * c * 4 for c in cfg.token_dims]


def test_buffers_take_the_largest_shape_and_every_graph_is_captured_again(served, cpu_graphs):
    m = served
    if isinstance(m, UniDepthV2):
        shapes = [(2, 60, 90, 3), (2, 30, 100, 3), (2, 90, 60, 3), (2, 100, 100, 3)]  # the last the largest
    else:  # V1 resizes every image into its network shape: the batch sets the stages' shapes
        shapes = [(1, 60, 90, 3), (2, 30, 100, 3), (3, 90, 60, 3), (4, 100, 100, 3)]
    eager = {}
    before = _counts()
    for i, shape in enumerate(shapes):
        eager[shape] = _infer(m, _rgb(i, shape))
        _infer(m, _rgb(i, shape))
    captures, replays, _ = _delta(before)
    assert replays == 2 * len(shapes) and captures >= 2 * len(shapes)
    sizes = {name: b.numel() for name, b in m._stage_graphs.buffers.items()}
    before = _counts()
    for i, shape in enumerate(shapes):  # every later call replays: nothing captured, nothing grown
        _equal(_infer(m, _rgb(i, shape)), eager[shape])
    assert _delta(before) == (0, 2 * len(shapes), {})
    assert {name: b.numel() for name, b in m._stage_graphs.buffers.items()} == sizes
    # one buffer per role, each the largest shape's: the encoder's image and its stage outputs
    h, w = _network_shape(m, shapes[-1][1:3])
    batch = shapes[-1][0]
    enc = {k[1:]: b.numel() for k, b in m._stage_graphs.buffers.items() if k[0] is m.pixel_encoder}
    outs = _encoder_buffer_bytes(m, batch, h, w)
    assert sorted(enc) == [("in", 0)] + [("out", g) for g in range(len(outs))]
    assert enc[("in", 0)] == batch * h * w * 3 * 4
    assert [enc[("out", g)] for g in range(len(outs))] == [-(-n // 16) * 16 for n in outs]


def test_threads_sharing_a_model_get_their_own_results(served, cpu_graphs):
    """The store's lock: threads replaying one model's graphs, switching
    often, each get their own image's result (without the lock one thread's
    image overwrites another's in the static buffers)."""
    import sys
    import threading

    m = served
    images = [_rgb(10 + i) for i in range(4)]
    want = [_infer(m, x)["depth"] for x in images]  # first sight: eager
    _infer(m, images[0])  # captured
    got, errors = {}, []

    def serve(i):
        try:
            got[i] = [_infer(m, images[i])["depth"] for _ in range(2)]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(len(images))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, depths in got.items():
        assert all(torch.equal(d, want[i]) for d in depths), i


def test_set_kernels_and_a_cast_drop_the_graphs(served, cpu_graphs):
    m = served
    _infer(m, _rgb(3))
    _infer(m, _rgb(3))
    assert m._stage_graphs.entries
    m.set_kernels(True)
    assert not m._stage_graphs.entries and not m._stage_graphs.buffers
    _infer(m, _rgb(3))
    _infer(m, _rgb(3))
    m.double()
    assert not m._stage_graphs.entries


@pytest.mark.parametrize("camera", [None, K], ids=["predicted-camera", "given-K"])
def test_warm_infer_reads_nothing_back_to_the_host(served, cpu_graphs, camera):
    """Once warm (eager, then captured), a request reads no tensor's value
    on the host: ``item``, ``tolist``, ``cpu``, ``numpy`` and a tensor's
    truth or number all raise. (V1 used to read the image's range with two
    ``item()`` calls.)"""
    m = served
    a, b = _rgb(4), _rgb(5)
    want = _infer(m, b, camera)
    _infer(m, a, camera)

    def host_read(*args, **kwargs):
        raise AssertionError("a tensor was read on the host inside a request")

    before = _counts()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__", "__int__"):
            mp.setattr(torch.Tensor, name, host_read)
        got = _infer(m, b, camera)
    assert _delta(before)[:2] == (0, 2)  # both stages replayed
    _equal(got, want)


# ----------------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_model(name: str, dev):
    cfg = json.loads((ROOT / "configs" / f"config_v2_{name}.json").read_text())
    return UniDepthV2.from_config(cfg, device=dev).init_params(seed=0).eval()


def _pinned(seed, shape):
    return torch.from_numpy(_rgb(seed, shape)).pin_memory()


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", [("vits14", 2), ("vitl14", 8)])
def test_card_replays_equal_the_eager_call(dev, name, batch):
    m = _card_model(name, dev)
    for shape in ((batch, 518, 518, 3), (batch, 375, 1242, 3)):
        a, b = _pinned(1, shape), _pinned(2, shape)
        before = _counts()
        eager_a = m.infer(a)
        captured = m.infer(a)
        replayed_b = m.infer(b)
        replayed_a = m.infer(a)
        torch.cuda.synchronize()
        assert _delta(before)[:2] == (2, 6), shape
        _equal(captured, eager_a)
        _equal(replayed_a, eager_a)
        m._stage_graphs.clear()
        _equal(replayed_b, m.infer(b))
        m._stage_graphs.clear()


@pytest.mark.cuda
def test_card_int8_serving_replays_equal_the_eager_call(dev):
    m = _card_model("vits14", dev)
    m.set_serving_precision("int8")
    a, b = _pinned(1, (2, 518, 518, 3)), _pinned(2, (2, 518, 518, 3))
    before = _counts()
    eager_a = m.infer(a)
    captured = m.infer(a)
    replayed_b = m.infer(b)
    torch.cuda.synchronize()
    assert _delta(before) == (2, 4, {"first sight": 2})
    _equal(captured, eager_a)
    m._stage_graphs.clear()
    _equal(replayed_b, m.infer(b))


@pytest.mark.cuda
def test_card_outputs_survive_later_calls_and_warm_calls_do_not_sync(dev):
    m = _card_model("vits14", dev)
    shapes = [(2, 518, 518, 3), (2, 375, 1242, 3), (2, 480, 640, 3), (2, 768, 1024, 3)]
    images = [_pinned(i, s) for i, s in enumerate(shapes)]
    for x in images:  # warm every shape: eager, then captured
        m.infer(x)
        m.infer(x)
    torch.cuda.synchronize()
    first = m.infer(images[0])
    kept = {k: v.clone() for k, v in first.items()}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in images[1:]:
            m.infer(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert set(first) == set(kept) and all(torch.equal(first[k], kept[k]) for k in kept)


@pytest.mark.cuda
def test_card_memory_of_four_shapes_is_one_shapes_buffers(dev):
    m = _card_model("vits14", dev)
    shapes = [(8, 480, 640, 3), (8, 375, 1242, 3), (8, 768, 1024, 3), (8, 1080, 1920, 3)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    largest = 0
    for i, s in enumerate(shapes):
        m.infer(_pinned(i, s))
        torch.cuda.synchronize()
        if i == 0:
            one = torch.cuda.memory_allocated(dev) - held  # what an eager call leaves (library workspaces)
        m.infer(_pinned(i, s))
        torch.cuda.synchronize()
        largest = max(largest, sum(b.numel() for b in m._stage_graphs.buffers.values()))
    grown = torch.cuda.memory_allocated(dev) - held
    buffers = sum(b.numel() for b in m._stage_graphs.buffers.values())
    assert buffers == largest  # the buffers of the largest shape, shared by all four
    assert grown <= buffers + one + (64 << 20), (grown, buffers, one)


@pytest.mark.cuda
def test_card_encode_decode_and_autograd_never_replay(dev):
    m = _card_model("vits14", dev)
    x = _pinned(0, (2, 518, 518, 3))
    m.infer(x)
    m.infer(x)
    image = torch.zeros(2, 518, 518, 3, device=dev)
    before = _counts()
    with torch.no_grad():
        m.encode_decode(image)
    m.encode_decode(image)["depth"].sum().backward()
    with stage_graphs.serving(m._stage_graphs):
        m.encode_decode(image)["depth"].sum().backward()
    m.zero_grad(set_to_none=True)
    assert _delta(before) == (0, 0, {"grad": 2})


def _card_v1(name: str, dev):
    cfg = json.loads((ROOT / "configs" / f"config_v1_{name}.json").read_text())
    return UniDepthV1.from_config(cfg, device=dev).init_params(seed=0).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cnvnxtl", "vitl14"])
def test_card_v1_replays_equal_the_eager_call_and_warm_calls_do_not_sync(dev, name):
    """V1 at B = 8 into its 462x616 network shape, without and with a K
    (numpy, as callers pass it): the captured call and the replays equal
    the eager calls bit for bit, and a warm call makes the host wait on
    nothing."""
    m = _card_v1(name, dev)
    shape = (8, 462, 616, 3)
    a, b = _pinned(1, shape), _pinned(2, shape)
    ks = np.stack([np.array([[500.0 + 10 * i, 0, 308.0], [0, 505.0, 231.0], [0, 0, 1]], np.float32) for i in range(8)])
    for camera in (None, ks):
        before = _counts()
        eager_a = m.infer(a, intrinsics=camera)
        captured = m.infer(a, intrinsics=camera)
        replayed_b = m.infer(b, intrinsics=camera)
        torch.cuda.synchronize()
        assert _delta(before) == (2, 4, {"first sight": 2})
        _equal(captured, eager_a)
        torch.cuda.set_sync_debug_mode("error")
        try:
            replayed_a = m.infer(a, intrinsics=camera)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        _equal(replayed_a, eager_a)
        m._stage_graphs.clear()
        _equal(replayed_b, m.infer(b, intrinsics=camera))
        m._stage_graphs.clear()


@pytest.mark.cuda
def test_card_v1_cell_is_correct_at_its_limits(dev):
    """The benchmark's V1 ConvNeXt-L cell on one seed, a 1 s window: the
    timed path's sampled outputs against the fp32 plain reference at the
    cell's limits (``benchmark/workloads/v1-cnvnxtl.serve-b8-462x616.json``)."""
    import time

    from benchmark.harness import session

    result, lines = session.run(ROOT, "v1-cnvnxtl.serve-b8-462x616", 2900002501, 1.0, False, "cuda",
                                time.perf_counter())
    assert result["correct"], lines

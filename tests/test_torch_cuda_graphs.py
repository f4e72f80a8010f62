"""V2 ``infer()``'s stage graphs (``models/stage_graphs.py``) and the
constants it builds once instead of on every call.

On the CPU (tier-1): the route runs eagerly on the CPU, under autograd and
under export, and counts why; the key separates ``confidence``, ``rays_gt``
and the input dtype; each cached constant equals its per-call construction
bit for bit; and, with a stand-in for the CUDA graph that replays by
running the captured stage again over the static buffers, the static
buffers' bookkeeping: the counters, replays equal to the eager call bit for
bit, a new image's own result, returned tensors that a later call leaves
alone, and the buffers grown once for four shapes.

On the card (marked ``cuda``, skipped without one; no JAX here):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py -q

the real graphs: a replayed ``infer()`` equals the eager first call bit for
bit at 518x518 and at a padded 375x1242, at ViT-S/14 and at ViT-L/14, and
under int8 serving; a replay with a new image gives that image's eager
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


def test_key_separates_confidence_rays_and_dtype():
    def key(*args):
        return stage_graphs._flatten(args, [])

    feats = [torch.zeros(2, 4, 6, 8)] * 4
    cls = [torch.zeros(2, 1, 8)] * 4
    rays = torch.zeros(2, 56 * 84, 3)
    base = key(feats, cls, (56, 84), None, True)
    assert base == key([t.clone() for t in feats], cls, (56, 84), None, True)  # values do not count
    assert len({base, key(feats, cls, (56, 84), None, False), key(feats, cls, (56, 84), rays, True),
                key([t.bfloat16() for t in feats], cls, (56, 84), None, True),
                key(feats, cls, (56, 70), None, True)}) == 5
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
           "unidepth.infer.decoder: void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16>(Params)": 40}
    assert profile_serve.kernel_ops(ops) == {"K1": 24, "K2": 24, "K2g": 3, "K2h": 1, "K3": 4, "K4": 0, "K5": 2}
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
def test_replays_equal_the_eager_call_and_own_their_outputs(model, cpu_graphs, camera):
    m = copy.deepcopy(model)
    a, b = _rgb(1), _rgb(2)
    before = _counts()
    eager_a = m.infer(a, camera=camera)
    assert _delta(before) == (0, 0, {"first sight": 2})
    captured = m.infer(a, camera=camera)
    assert _delta(before) == (2, 2, {"first sight": 2})
    _equal(captured, eager_a)
    replayed_b = m.infer(b, camera=camera)
    replayed_a = m.infer(a, camera=camera)
    assert _delta(before) == (2, 6, {"first sight": 2})
    _equal(replayed_a, eager_a)
    _equal(captured, eager_a)  # the tensors returned before are the caller's own
    if camera is not None:  # the decoder's rays are the given rays, read where they were copied in
        h, w = m.serving_shape_key(a.shape[1:3], True)[4]
        (rays,) = [v for k, v in m._stage_graphs.buffers.items() if k[0] is m.pixel_decoder and k[1] == "in"]
        assert rays.numel() == -(-2 * h * w * 3 * 4 // 16) * 16
    m._stage_graphs.clear()
    _equal(replayed_b, m.infer(b, camera=camera))  # b's eager result


def test_buffers_take_the_largest_shape_and_every_graph_is_captured_again(model, cpu_graphs):
    m = copy.deepcopy(model)
    shapes = [(2, 60, 90, 3), (2, 30, 100, 3), (2, 90, 60, 3), (2, 100, 100, 3)]  # the last the largest
    eager = {}
    before = _counts()
    for i, shape in enumerate(shapes):
        eager[shape] = m.infer(_rgb(i, shape))
        m.infer(_rgb(i, shape))
    captures, replays, _ = _delta(before)
    assert replays == 2 * len(shapes) and captures >= 2 * len(shapes)
    sizes = {name: b.numel() for name, b in m._stage_graphs.buffers.items()}
    before = _counts()
    for i, shape in enumerate(shapes):  # every later call replays: nothing captured, nothing grown
        _equal(m.infer(_rgb(i, shape)), eager[shape])
    assert _delta(before) == (0, 2 * len(shapes), {})
    assert {name: b.numel() for name, b in m._stage_graphs.buffers.items()} == sizes
    # one buffer per role, each the largest shape's: the encoder's image and its four stage outputs
    h, w = m.serving_shape_key(shapes[-1][1:3])[4]
    enc = {k[1:]: b.numel() for k, b in m._stage_graphs.buffers.items() if k[0] is m.pixel_encoder}
    assert sorted(enc) == [("in", 0)] + [("out", g) for g in range(4)]
    assert enc[("in", 0)] == 2 * h * w * 3 * 4
    assert all(v == 2 * (h // 14 * w // 14 + 1) * 128 * 4 for k, v in enc.items() if k[0] == "out")


def test_threads_sharing_a_model_get_their_own_results(model, cpu_graphs):
    """The store's lock: threads replaying one model's graphs, switching
    often, each get their own image's result (without the lock one thread's
    image overwrites another's in the static buffers)."""
    import sys
    import threading

    m = copy.deepcopy(model)
    images = [_rgb(10 + i) for i in range(4)]
    want = [m.infer(x)["depth"] for x in images]  # first sight: eager
    m.infer(images[0])  # captured
    got, errors = {}, []

    def serve(i):
        try:
            got[i] = [m.infer(images[i])["depth"] for _ in range(2)]
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


def test_set_kernels_and_a_cast_drop_the_graphs(model, cpu_graphs):
    m = copy.deepcopy(model)
    m.infer(_rgb(3))
    m.infer(_rgb(3))
    assert m._stage_graphs.entries
    m.set_kernels(True)
    assert not m._stage_graphs.entries and not m._stage_graphs.buffers
    m.infer(_rgb(3))
    m.infer(_rgb(3))
    m.double()
    assert not m._stage_graphs.entries


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

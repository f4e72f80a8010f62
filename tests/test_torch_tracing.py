"""The port's spans (``unidepth_tpu_torch/utils/tracing.py``) on the CPU.

Off, ``span`` is one shared no-op and nothing is recorded. On, one
``infer()`` of a full-width V2 ViT-S/14 (pixel budget shrunk), and of a tiny
V1 ConvNeXt, records the serving path's span tree under one request id, each
child inside its parent; outputs are bitwise those of an untraced call; with the kernel
library stubbed (as the route tests do) the kernel wrappers' spans count
what their ``.launches`` counters count, and a bf16 request read as one on
the card launches the heads' fused K5 once a head; annotated, the spans
show in a ``torch.profiler`` trace. Also ``scripts_torch/profile_serve.py``'s
reduction of an annotated trace, on a synthetic event list: each device
operation put down to its span through its correlation and ``cpu_parent``
chain, the host's waits, and the idle gaps' labels."""

import collections
import copy
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
import torch_threads  # noqa: F401  (sets this process's torch thread count)

from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.nn import layers
from unidepth_tpu_torch.ops import _cuda
from unidepth_tpu_torch.ops import attention as attention_mod
from unidepth_tpu_torch.ops import conv_kernels as ck
from unidepth_tpu_torch.ops import flash_attention as fa
from unidepth_tpu_torch.ops import fused_block as fb
from unidepth_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
PHASES = ["unidepth.infer.prepare", "unidepth.infer.encoder", "unidepth.infer.decoder", "unidepth.infer.postprocess"]
DECODER = ["unidepth.decoder.camera", "unidepth.decoder.prompt", "unidepth.decoder.pyramid", "unidepth.decoder.heads"]
DECODER_V1 = ["unidepth.decoder.camera", "unidepth.decoder.depth"]
KERNELS = ["unidepth.kernel.K1", "unidepth.kernel.K2", "unidepth.kernel.K3"]
RGB = np.random.default_rng(0).integers(0, 256, (2, 60, 90, 3), dtype=np.uint8)
K = np.array([[80.0, 0, 45.0], [0, 85.0, 30.0], [0, 0, 1]], np.float32)

# resolution_level is left unset: infer() warns and takes the default budget
pytestmark = pytest.mark.filterwarnings("ignore:resolution_level not set")

_spec = importlib.util.spec_from_file_location("profile_serve", ROOT / "scripts_torch" / "profile_serve.py")
profile_serve = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(profile_serve)


@pytest.fixture(scope="module")
def model():
    cfg = json.loads((ROOT / "configs" / "config_v2_vits14.json").read_text())
    cfg["data"]["augmentations"]["shape_constraints"].update(pixels_min=4000, pixels_max=10000)
    torch.manual_seed(0)
    return UniDepthV2.from_config(cfg, device="cpu").eval()


@pytest.fixture(scope="module")
def v1():
    cfg = {
        "model": {
            "name": "UniDepthV1", "num_heads": 4, "expansion": 4,
            "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
            "pixel_encoder": {"name": "convnext_large", "depths": [1, 1, 2, 1], "dims": [32, 64, 128, 256]},
        },
        "data": {"image_shape": [64, 96]},
    }
    return UniDepthV1.from_config(cfg, device="cpu").init_params(seed=0).eval()


@pytest.fixture(params=["v2", "v1"])
def served(request, model, v1):
    """The model and the decoder's span names it should record."""
    return (model, DECODER) if request.param == "v2" else (v1, DECODER_V1)


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.disable()
    tracing.collect()


class _StubLibrary:
    """The kernel library's stand-in: every entry reports success and
    writes nothing."""

    def __getattr__(self, entry):
        return lambda *args: 0


@pytest.fixture
def kernel_routes(monkeypatch):
    """CPU tensors take K1, K2 and K3's launch routes, into the stub: the
    wrappers' CPU branches lead to the routes, and the decoder's attention
    dispatches as on the card, at a token floor the small shape reaches."""
    monkeypatch.setattr(_cuda, "library", lambda: _StubLibrary())
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    monkeypatch.setattr(fa, "flash_attention_qkv_plain", fa._qkv_kernel)
    monkeypatch.setattr(fa, "flash_attention_plain", fa._flash_kernel)
    monkeypatch.setattr(fb, "ln_dense_plain", fb._ln_dense_kernel)

    def attention(q, k, v, bias=None):
        b, h, nq, d = q.shape
        if bias is not None or min(nq, k.shape[2]) < 8:
            return attention_mod.sdpa(q, k, v, bias=bias)
        out = fa.flash_attention(q.reshape(b * h, nq, d), k.reshape(b * h, -1, d), v.reshape(b * h, -1, d), d**-0.5)
        return out.reshape(b, h, nq, d)

    monkeypatch.setattr(layers, "attention", attention)


def _children(spans, parent):
    kids = sorted((s for s in spans if s["parent"] == parent["id"]), key=lambda s: s["host_start_ns"])
    return [s["name"] for s in kids]


def test_off_span_is_one_shared_noop(served, monkeypatch):
    model, _ = served
    assert tracing.span("unidepth.infer") is tracing.NO_SPAN
    assert tracing.span("unidepth.infer", torch.device("cuda")) is tracing.NO_SPAN

    def forbidden(*args, **kwargs):
        raise AssertionError("tracing is off")

    monkeypatch.setattr(tracing, "_Span", forbidden)
    monkeypatch.setattr(tracing, "_keep", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    model.infer(RGB)
    assert tracing.collect() == {"spans": [], "dropped": 0}


def test_infer_records_the_span_tree(served):
    model, decoder_spans = served
    tracing.enable()
    model.infer(RGB)
    spans = tracing.collect()["spans"]
    by_id = {s["id"]: s for s in spans}
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "unidepth.infer"
    assert {s["request"] for s in spans} == {root["request"]}
    assert _children(spans, root) == PHASES
    (decoder,) = [s for s in spans if s["name"] == "unidepth.infer.decoder"]
    assert _children(spans, decoder) == decoder_spans
    assert len(spans) == 1 + len(PHASES) + len(decoder_spans)  # CPU tensors run the plain versions: no kernel spans
    for s in spans:
        assert s["device_ms"] is None  # no CUDA device
        assert s["host_start_ns"] <= s["host_end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["host_start_ns"] <= s["host_start_ns"] and s["host_end_ns"] <= p["host_end_ns"]
    table = profile_serve.per_request(spans)
    assert set(table) == {s["name"] for s in spans}
    assert all(row["count"] == 1 and row["self_ms"] >= 0 for row in table.values())
    assert table["unidepth.infer.decoder"]["self_ms"] < table["unidepth.infer.decoder"]["host_ms"]


@pytest.mark.parametrize("camera", [None, K], ids=["predicted-camera", "given-K"])
def test_outputs_bitwise_equal_on_and_off(model, camera):
    off = model.infer(RGB, camera=camera)
    tracing.enable(annotate=True)
    on = model.infer(RGB, camera=camera)
    assert tracing.collect()["spans"]
    assert set(on) == set(off)
    for key in off:
        assert torch.equal(on[key], off[key]), key


def test_kernel_spans_count_the_launches(model, kernel_routes):
    wrappers = (fa.flash_attention_qkv, fb.ln_dense, fa.flash_attention)
    before = [w.launches for w in wrappers]
    tracing.enable()
    model.infer(RGB)
    spans = tracing.collect()["spans"]
    launched = [w.launches - b for w, b in zip(wrappers, before)]
    counts = collections.Counter(s["name"] for s in spans)
    assert [counts[k] for k in KERNELS] == launched
    assert launched == [12, 12, 4]  # ViT-S/14's 12 blocks; the decoder's four camera prompts
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] in KERNELS:
            assert s["device_ms"] is None  # host only
            parent = by_id[s["parent"]]["name"]
            assert parent == ("unidepth.decoder.prompt" if s["name"].endswith("K3") else "unidepth.infer.encoder")


@pytest.mark.parametrize("outputs,heads", [(None, 2), (("depth", "intrinsics"), 1)], ids=["all", "no-confidence"])
def test_k5_spans_count_the_fused_heads(model, monkeypatch, outputs, heads):
    """bf16 weights and CPU tensors read as CUDA ones (``is_cuda``): each
    head's hr tail takes K5's fused launch (into the stubbed library) in the
    heads span, twice a request, once with the confidence left out."""
    monkeypatch.setattr(_cuda, "library", lambda: _StubLibrary())
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    monkeypatch.setattr(ck, "conv3x3_head_plain", ck._head_kernel)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    bf16 = copy.deepcopy(model).to(torch.bfloat16)
    before = ck.conv3x3_lowchannel.launches, ck.conv3x3_lowchannel.hopper_launches
    tracing.enable()
    bf16.infer(RGB, outputs=outputs)
    spans = tracing.collect()["spans"]
    after = ck.conv3x3_lowchannel.launches, ck.conv3x3_lowchannel.hopper_launches
    assert after == (before[0] + heads, before[1] + heads)
    k5 = [s for s in spans if s["name"] == "unidepth.kernel.K5"]
    assert len(k5) == heads
    by_id = {s["id"]: s for s in spans}
    assert {by_id[s["parent"]]["name"] for s in k5} == {"unidepth.decoder.heads"}


@pytest.mark.parametrize("annotate", [True, False])
def test_annotated_spans_show_in_a_profiler_trace(model, kernel_routes, annotate):
    from torch.profiler import ProfilerActivity, profile

    tracing.enable(annotate=annotate)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.infer(RGB)
    events = prof.events()
    names = {e.name for e in events if e.name.startswith("unidepth.")}
    if not annotate:
        assert names == set()
        return
    assert names == {"unidepth.infer", *PHASES, *DECODER, *KERNELS}
    for e in events:
        if e.name in KERNELS[:2]:
            assert profile_serve._spans_of(e)[1:] == ["unidepth.infer.encoder", "unidepth.infer"]


def test_collect_clears_and_the_bound_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(tracing, "_buffer", collections.deque(maxlen=3))
    tracing.enable()
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    got = tracing.collect()
    assert [s["name"] for s in got["spans"]] == ["s2", "s3", "s4"] and got["dropped"] == 2
    assert len({s["request"] for s in got["spans"]}) == 3  # each outermost span is a request
    assert tracing.collect() == {"spans": [], "dropped": 0}


def test_phase_spans_time_the_device_except_under_capture(monkeypatch):
    class Event:
        clock = 0.0

        def __init__(self, enable_timing):
            assert enable_timing

        def record(self, stream):
            Event.clock += 1.5
            self.at = Event.clock

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.at - self.at

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    tracing.enable()
    cuda = torch.device("cuda")
    with tracing.span("phase", cuda):
        with tracing.span("kernel"):
            pass
    capturing[0] = True
    with tracing.span("captured", cuda):
        pass
    got = {s["name"]: s["device_ms"] for s in tracing.collect()["spans"]}
    assert got == {"phase": 1.5, "kernel": None, "captured": None}


def _event(id, name, start, end, parent=None, device=False, annotation=False, thread=1):
    return SimpleNamespace(id=id, name=name, time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, is_user_annotation=annotation,
                           thread=thread)


def test_reduce_attributes_by_correlation_counts_waits_and_labels_gaps():
    """A request whose decoder prompt launches a GEMM (through aten::linear),
    a pageable upload that synchronises (aten::to) and K3 (a kernel span,
    its kernel running after the span closed); its post-processing copies to
    pageable memory; the harness then copies and synchronises (an operation
    whose id is also a launch's correlation id). Times in microseconds."""
    ev = []

    def add(*args, **kwargs):
        ev.append(_event(*args, **kwargs))
        return ev[-1]

    infer = add(1, "unidepth.infer", 0, 100)
    decoder = add(2, "unidepth.infer.decoder", 10, 90, infer)
    prompt = add(3, "unidepth.decoder.prompt", 20, 60, decoder)
    linear = add(4, "aten::linear", 22, 30, prompt)
    add(100, "cudaLaunchKernel", 23, 24, linear)
    to = add(5, "aten::to", 31, 40, prompt)
    copy = add(6, "aten::copy_", 32, 39, to)
    add(101, "cudaMemcpyAsync", 32, 33, copy)
    add(102, "cudaStreamSynchronize", 33, 38, copy)
    k3 = add(9, "unidepth.kernel.K3", 41, 45, prompt)
    add(104, "cudaLaunchKernel", 42, 43, k3)
    post = add(7, "unidepth.infer.postprocess", 91, 99, infer)
    down = add(8, "aten::copy_", 92, 98, post)
    add(103, "cudaMemcpyAsync", 92, 97, down)
    harness = add(100, "aten::copy_", 100, 102)
    add(105, "cudaStreamSynchronize", 100, 101, harness)
    add(101, "Memcpy HtoD (Pageable -> Device)", 33, 34, device=True)
    add(100, "gemm", 40, 50, device=True)
    add(104, "attn_fwd_wgmma", 60, 70, device=True)
    add(103, "Memcpy DtoH (Device -> Pageable)", 93, 95, device=True)
    add(200, "unidepth.infer.decoder", 40, 90, annotation=True, device=True)

    got = profile_serve.reduce(ev)
    assert got["requests"] == 1
    assert got["launches"] == {"unidepth.infer": 4, "unidepth.infer.decoder": 3, "unidepth.decoder.prompt": 3,
                               "unidepth.kernel.K3": 1, "unidepth.infer.postprocess": 1}
    assert got["ops"] == {"unidepth.infer.decoder: Memcpy HtoD (Pageable -> Device)": 1,
                          "unidepth.infer.decoder: gemm": 1, "unidepth.infer.decoder: attn_fwd_wgmma": 1,
                          "unidepth.infer.postprocess: Memcpy DtoH (Device -> Pageable)": 1}
    assert got["device_s"] == pytest.approx({"unidepth.decoder.prompt": 11e-6, "unidepth.kernel.K3": 10e-6,
                                             "unidepth.infer.postprocess": 2e-6})
    assert got["waits"] == {"unidepth.decoder.prompt: aten::to: cudaStreamSynchronize": 1,
                            "unidepth.infer.postprocess: aten::copy_: Memcpy DtoH (Device -> Pageable)": 1}
    assert got["busy_s"] == pytest.approx(23e-6) and got["span_s"] == pytest.approx(62e-6)
    assert got["idle"] == pytest.approx({"unidepth.decoder.prompt: aten::to": 6e-6, "unidepth.decoder.prompt": 10e-6,
                                         "unidepth.infer.decoder": 23e-6})


@pytest.mark.parametrize("cell,decoder_spans", [("tiny-v2.serve", DECODER), ("tiny-v1.serve", DECODER_V1)],
                         ids=["v2", "v1"])
def test_profile_serve_runs_a_tiny_cell_on_the_cpu(tmp_path, cell, decoder_spans):
    """The script's run over a benchmark cell (the benchmark's own CPU test
    cells: a ViT of width 32 and a tiny V1 ConvNeXt): spans per request, on
    and off blocks, and an annotated profile, which on the CPU holds no
    device operation."""
    from benchmark.tests.conftest import make_root

    got = profile_serve.profile(make_root(tmp_path), cell, 3000000019, 0.2, device="cpu")
    assert got["device"] == "cpu" and set(got["images_per_s"]) == {"off", "on"}
    assert {"unidepth.infer", *PHASES, *decoder_spans} <= set(got["spans"])
    assert got["spans"]["unidepth.infer"]["count"] == 1
    assert got["metrics"]["decoder_host_ms"] > 0 and got["metrics"]["encoder_host_ms"] > 0
    assert got["metrics"]["decoder_launches"] == 0 and got["metrics"]["host_syncs"] == 0
    assert got["traced"]["requests"] > 0 and got["traced"]["busy_s"] == 0.0
    assert got["kernel_ops"] == {k: 0.0 for k in ("K1", "K2", "K2g", "K2h", "K3", "K4", "K5", "dwconv")}  # no device op
    assert got["graphs"]["replays"] == 0 and got["graphs"]["eager"] == {"cpu": 2.0}  # the two stages, eagerly
    assert got["graphs"]["replay_share"] == 0.0

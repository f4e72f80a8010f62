"""The port's ``torch.export`` exporter (unidepth_tpu_torch/models/unidepthv2/
export.py) against the JAX exporter's model on shared weights (fp32, CPU),
at tests/test_export_hub.py's tiny model (C = 64, 4 blocks, 2 heads, decoder
(1, 1, 1), 56 x 70). The bytes round-trip through ``torch.export.load`` and
the loaded program's points are held to the JAX model's live
``encode_decode`` at rtol 1e-4, atol 1e-3 (the JAX test's bound for its own
export against its live forward); confidence and intrinsics at the same.
The saved graph holds only aten operators."""

import io
import operator
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidepth_tpu.models.unidepthv2.model import UniDepthV2 as JUniDepthV2
from unidepth_tpu_torch.io.convert import from_jax_params
from unidepth_tpu_torch.models.unidepthv2.export import export_forward
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2

CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2,
        "pixel_decoder": {"hidden_dim": 32, "out_dim": 8, "depths": [1, 1, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2,
            "pos_embed_size": 8, "output_idx": [1, 2, 3, 4], "use_norm": True,
        },
    },
}
SHAPE = (56, 70)
TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def models():
    jm = JUniDepthV2.from_config(CFG, dtype=jnp.float32)
    jm.params = jax.jit(lambda: jm.init_params(seed=0, image_shape=SHAPE))()  # eager init takes ~30 s
    rng = np.random.default_rng(0)
    jm.params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape).astype(np.float32), jm.params
    )
    tm = UniDepthV2.from_config(CFG, device="cpu").eval()
    tm.load_state_dict(from_jax_params(jm.params, CFG))
    return jm, tm


def _inputs(with_camera):
    rng = np.random.default_rng(3)
    img = rng.standard_normal((1, *SHAPE, 3)).astype(np.float32)
    rays = rng.standard_normal((1, SHAPE[0] * SHAPE[1], 3)).astype(np.float32)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return (img, rays) if with_camera else (img,)


@pytest.mark.parametrize("with_camera", [False, True], ids=["image", "image-rays"])
def test_export_matches_jax_forward(models, with_camera):
    jm, tm = models
    blob = export_forward(tm, SHAPE, with_camera=with_camera)
    assert isinstance(blob, bytes) and len(blob) > 1000
    program = torch.export.load(io.BytesIO(blob))
    targets = {n.target for n in program.graph.nodes if n.op == "call_function"}
    foreign = {t for t in targets if t is not operator.getitem and not str(t).startswith("aten.")}
    assert not foreign, f"non-aten operators in the exported graph: {foreign}"
    inputs = _inputs(with_camera)
    with torch.no_grad():
        pts, conf, K = program.module()(*(torch.from_numpy(a) for a in inputs))
    assert pts.shape == (1, *SHAPE, 3) and conf.shape == (1, *SHAPE, 1) and K.shape == (1, 3, 3)
    rays = jnp.asarray(inputs[1]) if with_camera else None
    ref = jax.jit(jm.encode_decode)(jm.params, jnp.asarray(inputs[0]), rays)
    np.testing.assert_allclose(pts.numpy(), np.asarray(ref["points"]), **TOL)
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref["confidence"]), **TOL)
    np.testing.assert_allclose(K.numpy(), np.asarray(ref["intrinsics"]), **TOL)


def test_export_restores_the_kernel_flags_when_the_trace_raises(models, monkeypatch):
    """A module pinned to its plain version stays pinned and the others
    get their kernels back, after a trace that raises."""
    _, tm = models
    pinned = tm.pixel_decoder.depth_layer.prompt_camera[0].layers[0]
    pinned.use_kernels = False
    seen = []

    def broken(*args, **kwargs):
        seen.append({m.use_kernels for m in tm.modules() if hasattr(m, "use_kernels")})
        raise RuntimeError("trace failed")

    monkeypatch.setattr(torch.export, "export", broken)
    try:
        with pytest.raises(RuntimeError, match="trace failed"):
            export_forward(tm, SHAPE)
        assert seen == [{False}]  # the trace saw the plain versions only
        flags = {m: m.use_kernels for m in tm.modules() if hasattr(m, "use_kernels")}
        assert flags.pop(pinned) is False and set(flags.values()) == {True}
    finally:
        pinned.use_kernels = True


def test_export_keeps_the_hr_heads_on_the_modules(models, monkeypatch):
    """The trace runs under ``set_kernels(False)``, which pins both heads'
    hr tails to the modules: ``DepthHead``'s route is asked and says no."""
    from unidepth_tpu_torch.models.unidepthv2.decoder import DepthHead

    _, tm = models
    route = DepthHead._hr_on_k5
    seen = []

    def spy(self, y, hr, out_hw):
        seen.append((self.use_kernels, route(self, y, hr, out_hw)))
        return seen[-1][1]

    monkeypatch.setattr(DepthHead, "_hr_on_k5", spy)
    export_forward(tm, (56, 70))
    assert seen == [(False, False), (False, False)]
    assert tm.pixel_decoder.depth_layer.use_kernels  # restored after the trace


def test_exported_bytes_load_without_the_port(models, tmp_path):
    """A process that imports torch only (the repository is not on its
    path) loads the archive and runs it."""
    _, tm = models
    (tmp_path / "m.pt2").write_bytes(export_forward(tm, SHAPE))
    img = _inputs(False)[0]
    np.save(tmp_path / "img.npy", img)
    code = (
        "import sys, numpy as np, torch\n"
        "p = torch.export.load(sys.argv[1] + '/m.pt2')\n"
        "assert not any(m.startswith('unidepth_tpu') for m in sys.modules)\n"
        "pts = p.module()(torch.from_numpy(np.load(sys.argv[1] + '/img.npy')))[0]\n"
        "np.save(sys.argv[1] + '/pts.npy', pts.detach().numpy())\n"
    )
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], check=True, cwd=tmp_path, timeout=300)
    with torch.no_grad():
        want = tm.encode_decode(torch.from_numpy(img))["points"]
    np.testing.assert_allclose(np.load(tmp_path / "pts.npy"), want.numpy(), rtol=1e-5, atol=1e-5)


def test_export_cli(tmp_path, monkeypatch):
    """``python -m unidepth_tpu_torch.models.unidepthv2.export``: the shape
    floored to 14, the archive written; without a card and without
    ``--device cpu`` it raises before building anything."""
    import json

    from unidepth_tpu_torch.models.unidepthv2 import export

    (tmp_path / "tiny.json").write_text(json.dumps(CFG))
    argv = ["--config-file", str(tmp_path / "tiny.json"), "--shape", "60", "75", "--output", str(tmp_path / "m.pt2")]
    export.main([*argv, "--device", "cpu", "--with-camera"])
    program = torch.export.load(str(tmp_path / "m.pt2"))
    image, rays = (n.meta["val"].shape for n in program.graph.nodes if n.op == "placeholder" and n.users
                   and n.name in program.graph_signature.user_inputs)
    assert tuple(image) == (1, 56, 70, 3) and tuple(rays) == (1, 56 * 70, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        export.main(argv)


@pytest.mark.slow
def test_export_matches_the_jax_blob(models):
    """The loaded program against the deserialised JAX StableHLO export of
    the same weights."""
    from jax import export as jax_export

    from unidepth_tpu.models.unidepthv2.export import export_forward as jax_export_forward

    jm, tm = models
    restored = jax_export.deserialize(jax_export_forward(jm, jm.params, SHAPE, batch=1))
    img = _inputs(False)[0]
    want = restored.call(jm.params, jnp.asarray(img))
    program = torch.export.load(io.BytesIO(export_forward(tm, SHAPE)))
    with torch.no_grad():
        got = program.module()(torch.from_numpy(img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

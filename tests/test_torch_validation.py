"""The port's evaluation entry points against the JAX package on shared
weights (fp32, CPU).

* ``validate()`` with the 3-D metrics on a small UniDepthV2 (C = 64, 4
  blocks) and a small UniDepthV1 (the JAX V1 tests' size), a Dummy loader of
  2 batches of 2 at 56 x 84 (no token centre on the Dummy principal point):
  the continuous metrics at rtol 1e-3 (the depth contract,
  docs/PARITY.md:148), the metrics that count pixels within one pixel a
  sample (1 / n_valid; F1 two points, its precision and recall each).
* V2 ``infer(rgb, camera=...)`` with each camera model, with a mixed
  ``BatchCamera`` and with a one-camera batch broadcast to B: depth max
  relative error < 1e-3, rays atol 1e-4 (the Newton models' ray parity,
  tests/test_torch_cameras.py).
* The EMA swap: inside ``Trainer.validate`` the model holds the shadow, and
  after it the live weights (bf16 and fp32) and the masters are bitwise
  what they were.
* The eval, demo and train CLIs with ``--device cpu`` on a small config,
  and the PNG codec against PIL on the demo assets.
"""

import copy
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unidepth_tpu.geometry import cameras as jcam
from unidepth_tpu.io.convert import convert_v1_state_dict, convert_v2_state_dict
from unidepth_tpu.models.backbones.dinov2 import ViTConfig as JViTConfig
from unidepth_tpu.models.unidepthv1.model import UniDepthV1 as JUniDepthV1
from unidepth_tpu.models.unidepthv2.model import UniDepthV2 as JUniDepthV2
from unidepth_tpu.utils.validation import validate as j_validate
from unidepth_tpu_torch.datasets.dummy import Dummy
from unidepth_tpu_torch.datasets.loader import eval_batches
from unidepth_tpu_torch.geometry import cameras as tcam
from unidepth_tpu_torch.models.unidepthv1.model import UniDepthV1
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.training.ema import EMAState, ema_weights
from unidepth_tpu_torch.training.trainer import build_trainer
from unidepth_tpu_torch.utils.evaluation import DEPTH_METRICS
from unidepth_tpu_torch.utils.validation import validate

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (56, 84)
COUNTING = ("d1", "d2", "d3", "tau", "d_auc", "d1_ssi", "tau_ssi", "d1_si", "tau_si")

V2_CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2, "expansion": 4, "layer_scale": 1.0,
        "pixel_decoder": {"hidden_dim": 64, "out_dim": 16, "depths": [1, 1, 1]},
        "pixel_encoder": {"name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2, "pos_embed_size": 8,
                          "output_idx": [1, 2, 3, 4], "use_norm": True},
    },
    "data": {"image_shape": list(SHAPE), "augmentations": {"shape_constraints": {
        "ratio_bounds": [0.5, 2.5], "pixels_min": 4000, "pixels_max": 10000}}},
}
V1_CFG = {
    "model": {"name": "UniDepthV1", "num_heads": 4, "expansion": 4,
              "pixel_decoder": {"hidden_dim": 32, "depths": [1, 1, 1]},
              "pixel_encoder": {"name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2,
                                "pos_embed_size": 8, "output_idx": [1, 2, 3, 4]}},
    "data": {"image_shape": [56, 70]},
}
V1_VIT = dict(embed_dim=64, depth=4, num_heads=2, pos_embed_size=8, output_idx=(1, 2, 3, 4), use_norm=False,
              interpolate_offset=0.1)

pytestmark = pytest.mark.filterwarnings("ignore:resolution_level not set")


def _noisy_state(model, seed):
    rng = np.random.default_rng(seed)
    sd = {k: (v.numpy() + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
          for k, v in model.state_dict().items()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return sd


@pytest.fixture(scope="module")
def v2_models():
    tm = UniDepthV2.from_config(V2_CFG, device="cpu").init_params(seed=0).eval()
    sd = _noisy_state(tm, 0)
    jm = JUniDepthV2.from_config(V2_CFG, dtype=jnp.float32)
    jm.params = convert_v2_state_dict(sd, output_idx=(1, 2, 3, 4), num_levels=3, use_norm=True)
    return jm, tm


@pytest.fixture(scope="module")
def v1_models():
    tm = UniDepthV1.from_config(V1_CFG, device="cpu").init_params(seed=0).eval()
    sd = _noisy_state(tm, 1)
    jm = JUniDepthV1(JViTConfig(**V1_VIT), hidden_dim=32, decoder_depths=(1, 1, 1), num_heads=4, image_shape=(56, 70),
                     dtype=jnp.float32)
    jm.params = convert_v1_state_dict(sd, output_idx=(1, 2, 3, 4), backbone="dinov2", use_norm=False)
    return jm, tm


def _loaders():
    return {"Dummy": eval_batches(Dummy(image_shape=SHAPE, length=4), 2)}


@pytest.mark.parametrize("family", ["v2", "v1"])
def test_validate_matches_jax(family, request):
    jm, tm = request.getfixturevalue(f"{family}_models")
    ranges = {"Dummy": (0.1, 10.0)}
    got = validate(tm, _loaders(), with_3d=True, depth_ranges=ranges)["Dummy"]
    want = j_validate(jm, jm.params, _loaders(), with_3d=True, depth_ranges=ranges)["Dummy"]
    assert set(got) == set(want) == {*DEPTH_METRICS, "chamfer", "F1"}
    n_valid = SHAPE[0] * SHAPE[1]  # Dummy: every pixel valid
    for k in got:
        assert np.isfinite(got[k]), k
        if k in COUNTING:
            assert abs(got[k] - want[k]) <= 1.0 / n_valid + 1e-9, (k, got[k], want[k])
        elif k == "F1":
            assert abs(got[k] - want[k]) <= 2.0 / n_valid + 1e-9, (k, got[k], want[k])
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


# the cameras at the image's scale (56 x 84), principal points off the pixel
# and token centres; Spherical's W != 84, so no ray has x exactly 0
CAMERAS = {
    "Pinhole": [60.0, 62.0, 40.3, 27.7],
    "EUCM": [60.0, 61.0, 40.3, 27.7, 0.55, 1.05],
    "Spherical": [13.0, 13.0, 41.7, 27.7, 83.2, 56.0, 0.45 * np.pi, 0.3 * np.pi],
    "OpenCV": [60.0, 61.0, 40.3, 27.7, 0.04, -0.01, 0.001, 0, 0, 0, 0.004, -0.003, 0.001, 0, -0.001, 0],
    "Fisheye624": [58.0, 58.0, 40.3, 27.7, 0.08, -0.01, 0.002, 0, 0, 0, 0.001, -0.001, 0.001, 0, 0, 0],
    "MEI": [60.0, 60.0, 40.3, 27.7, 0.04, -0.01, 0.001, 0.0, 0.5],
}


def _camera_pair(name, b):
    p = np.tile(np.asarray(CAMERAS[name], np.float32), (b, 1))
    p[1:, :2] *= 1.05  # the second camera another focal length
    return getattr(jcam, name)(params=jnp.asarray(p)), getattr(tcam, name)(torch.from_numpy(p))


def _batch_pair(names):
    pairs = [_camera_pair(n, 1) for n in names]
    return jcam.BatchCamera.concat([j for j, _ in pairs]), tcam.BatchCamera.concat([t for _, t in pairs])


@pytest.mark.parametrize("camera", [*CAMERAS, "BatchCamera", "BatchCamera-broadcast"])
def test_v2_infer_with_any_camera_matches_jax(v2_models, camera):
    jm, tm = v2_models
    rgb = np.random.default_rng(5).integers(0, 256, (2, *SHAPE, 3), dtype=np.uint8)
    if camera == "BatchCamera":
        jc, tc = _batch_pair(["Fisheye624", "MEI"])
    elif camera == "BatchCamera-broadcast":  # a one-camera batch and its type id broadcast to B = 2
        jc, tc = _batch_pair(["OpenCV"])
    else:
        jc, tc = _camera_pair(camera, 2)
    ref = jm.infer(rgb, camera=jc)
    out = tm.infer(rgb, camera=tc)
    d_ref = np.asarray(ref["depth"])
    assert (np.abs(out["depth"].numpy() - d_ref) / np.abs(d_ref)).max() < 1e-3
    np.testing.assert_allclose(out["rays"].numpy(), np.asarray(ref["rays"]), atol=1e-4)
    np.testing.assert_allclose(out["intrinsics"].numpy(), np.asarray(ref["intrinsics"]), rtol=1e-4, atol=1e-4)


def test_infer_rays_follow_the_camera(v2_models):
    """A mixed batch's rays are each member's own, in the port alone."""
    _, tm = v2_models
    rgb = np.random.default_rng(6).integers(0, 256, (2, *SHAPE, 3), dtype=np.uint8)
    _, tc = _batch_pair(["Pinhole", "Spherical"])
    mixed = tm.infer(rgb, camera=tc)["rays"]
    for i, name in enumerate(["Pinhole", "Spherical"]):
        alone = tm.infer(rgb[i : i + 1], camera=_camera_pair(name, 1)[1])["rays"]
        torch.testing.assert_close(mixed[i : i + 1], alone, rtol=1e-5, atol=1e-5)


def test_ema_weights_restores_the_live_weights_bitwise():
    """A bf16 module and an fp32 shadow: inside, the shadow cast to bf16;
    after, the live bf16 values bit for bit."""
    lin = torch.nn.Linear(8, 4).to(torch.bfloat16)
    live = {n: p.detach().clone() for n, p in lin.named_parameters()}
    shadow = {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) for n, p in lin.named_parameters()}
    with ema_weights(lin, EMAState(shadow=shadow, num_updates=3)):
        for n, p in lin.named_parameters():
            assert torch.equal(p, shadow[n].to(torch.bfloat16))
    for n, p in lin.named_parameters():
        assert torch.equal(p, live[n])


def test_trainer_validates_under_the_ema_shadow():
    cfg = json.loads((ROOT / "configs/config_v2_vitl14.json").read_text())
    cfg["model"].update(V2_CFG["model"])
    cfg["data"]["image_shape"] = list(SHAPE)
    trainer = build_trainer(cfg, device="cpu", seed=0)
    g = torch.Generator().manual_seed(2)
    for t in trainer.state.ema.shadow.values():  # a shadow unlike the weights
        t.add_(0.01 * torch.randn(t.shape, generator=g))
    live = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    masters = {n: t.clone() for n, t in trainer.state.params.items()}
    got = trainer.validate(_loaders())["Dummy"]
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, live[n]), n
        assert torch.equal(trainer.state.params[n], masters[n]), n
    shadow_model = copy.deepcopy(trainer.model)
    with torch.no_grad():
        for n, p in shadow_model.named_parameters():
            p.copy_(trainer.state.ema.shadow[n])
    assert validate(shadow_model, _loaders())["Dummy"] == got
    assert validate(trainer.model, _loaders())["Dummy"] != got


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_script", ROOT / "scripts_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny_configs(tmp_path):
    paths = {}
    for family, small in (("v2", V2_CFG), ("v1", V1_CFG)):
        cfg = json.loads((ROOT / f"configs/config_{family}_vitl14.json").read_text())
        cfg["model"].update(small["model"])
        cfg["data"].update(small["data"])
        paths[family] = tmp_path / f"{family}.json"
        paths[family].write_text(json.dumps(cfg))
    return paths


@pytest.mark.parametrize("family", ["v2", "v1"])
def test_eval_cli_on_the_cpu(tiny_configs, family, capsys):
    results = _script("eval").main(["--config-file", str(tiny_configs[family]), "--dummy-data", "--eval-3d",
                                    "--max-iters", "1", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "random weights" in out
    line = json.loads(out.strip().splitlines()[-1])
    assert line == {"eval": results}
    assert set(results["Dummy"]) == {*DEPTH_METRICS, "chamfer", "F1"}
    assert all(np.isfinite(v) for v in results["Dummy"].values())


def test_eval_cli_refuses_what_is_not_ported(tiny_configs, tmp_path, monkeypatch):
    cfg = json.loads(tiny_configs["v2"].read_text())
    monkeypatch.delenv("DATAROOT", raising=False)
    with pytest.raises(SystemExit, match=r"no data root for \['KITTI'\]: pass --data-root"):
        _script("eval").main(["--config-file", str(tiny_configs["v2"]), "--datasets", "KITTI", "--device", "cpu"])
    cfg["model"]["name"] = "UniDepthV3"  # no such family (UniDepthV2old is ported: tests/test_torch_v2old.py)
    unknown = tmp_path / "unknown.json"
    unknown.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="unknown model UniDepthV3"):
        _script("eval").main(["--config-file", str(unknown), "--dummy-data", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, argv in (("eval", ["--config-file", str(tiny_configs["v2"]), "--dummy-data"]), ("demo", [])):
        with pytest.raises(SystemExit, match="--device cpu"):
            _script(name).main(argv)


def test_eval_cli_on_hdf5_shards(tiny_configs, tmp_path, capsys):
    """``--datasets KITTI NYUv2Depth`` over synthetic shards under
    ``--data-root``, each in test mode (KITTI's pre-crop and garg crop,
    NYUv2Depth's eigen crop): every depth metric, finite."""
    from unidepth_tpu_torch.datasets.synthetic import make_shards, write_hdf5

    write_hdf5(tmp_path, make_shards(["KITTI", "NYUv2Depth"], 3, 0,
                                     shapes={"KITTI": (356, 1222), "NYUv2Depth": (48, 64)}))
    results = _script("eval").main(["--config-file", str(tiny_configs["v2"]), "--data-root", str(tmp_path),
                                    "--datasets", "KITTI", "NYUv2Depth", "--batch", "2", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"eval": results} and sorted(results) == ["KITTI", "NYUv2Depth"]
    for metrics in results.values():
        assert set(metrics) == set(DEPTH_METRICS) and all(np.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("version", [2, 1])
def test_demo_cli_on_the_cpu(tiny_configs, version, tmp_path, capsys):
    from unidepth_tpu_torch.utils.png import read_png

    output = tmp_path / "panel.png"
    arel = _script("demo").main(["--version", str(version), "--config", str(tiny_configs[f"v{version}"]),
                                 "--rgb", str(ROOT / "assets/demo/rgb.png"), "--depth",
                                 str(ROOT / "assets/demo/depth.png"), "--intrinsics",
                                 str(ROOT / "assets/demo/intrinsics.npy"), "--output", str(output), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "random weights" in out and f"ARel: {arel * 100:.2f}%" in out
    assert np.isfinite(arel) and arel > 0
    assert read_png(output).shape == (480, 3 * 640, 3)


def test_train_cli_validates_under_the_ema(tiny_configs, tmp_path, capsys):
    _script("train").main(["--config-file", str(tiny_configs["v2"]), "--dummy-data", "--device", "cpu", "--steps", "2",
                           "--val-interval", "2", "--val-iters", "1", "--checkpoint-dir", str(tmp_path / "ckpt")])
    vals = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith('{"step": 2, "val"')]
    assert len(vals) == 1
    assert set(vals[0]["val"]["Dummy"]) == set(DEPTH_METRICS)
    assert all(np.isfinite(v) for v in vals[0]["val"]["Dummy"].values())


def test_png_codec_reads_and_writes_the_demo_formats(tmp_path):
    """``utils.png`` decodes the demo's 8-bit RGB and 16-bit grey PNGs as
    PIL does (every filter type they use), and its files read back, in
    both codecs, bit for bit."""
    from PIL import Image

    from unidepth_tpu_torch.utils.png import read_png, write_png

    for name in ("rgb.png", "depth.png"):
        img = read_png(ROOT / "assets/demo" / name)
        np.testing.assert_array_equal(img, np.asarray(Image.open(ROOT / "assets/demo" / name)).astype(img.dtype))
        write_png(tmp_path / name, img)
        np.testing.assert_array_equal(read_png(tmp_path / name), img)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)).astype(img.dtype), img)
    with pytest.raises(ValueError, match="unsupported"):
        write_png(tmp_path / "x.png", np.zeros((4, 4, 4), np.uint8))

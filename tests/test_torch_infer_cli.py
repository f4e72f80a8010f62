"""``scripts_torch/infer.py`` on the CPU with a tiny config, on a folder of
two image sizes (a PNG and a JPEG of one, a NuScenes-style 6-view layout of
two frames in the other): the JAX CLI's output names, 16-bit depth PNGs
equal to ``clip(depth * 1000)`` of a direct ``infer()`` of the same batch
(the same CPU computation: within 1 mm, rounding included), PLY files of
H * W vertices byte for byte what the JAX writer writes, and panels. The JAX CLI
builds ViT-L/14 without a checkpoint and has no ``--config``, so the names
are held to its rule, ``"_".join`` of the path relative to the input."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from unidepth_tpu.utils.visualization import save_point_cloud as jax_save_point_cloud
from unidepth_tpu_torch.models.unidepthv2.model import UniDepthV2
from unidepth_tpu_torch.utils.png import read_png, write_png

ROOT = Path(__file__).resolve().parents[1]
CFG = {
    "model": {
        "name": "UniDepthV2", "num_heads": 2,
        "pixel_decoder": {"hidden_dim": 32, "out_dim": 8, "depths": [1, 1, 1]},
        "pixel_encoder": {
            "name": "dinov2_vits14", "embed_dim": 64, "depth": 4, "num_heads": 2,
            "pos_embed_size": 8, "output_idx": [1, 2, 3, 4], "use_norm": True,
        },
    },
    "data": {"augmentations": {"shape_constraints": {
        "ratio_bounds": [0.5, 2.5], "pixels_min": 2000, "pixels_max": 4000}}},
}
CAMS = ("CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT", "CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT")
SMALL, FRAME = (40, 60), (36, 64)  # (H, W)

pytestmark = pytest.mark.filterwarnings("ignore:resolution_level not set")


def _load_cli():
    spec = importlib.util.spec_from_file_location("torch_infer_cli", ROOT / "scripts_torch" / "infer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The folder, the config and one CLI run with --save-ply --save-panel at
    batch 4: buckets of 2 and 12 images, 1 + 3 batches."""
    tmp = tmp_path_factory.mktemp("infer_cli")
    src, out = tmp / "in", tmp / "out"
    rng = np.random.default_rng(0)
    (src / "assets").mkdir(parents=True)
    write_png(src / "assets" / "rgb.png", rng.integers(0, 256, (*SMALL, 3), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (*SMALL, 3), dtype=np.uint8)).save(src / "assets" / "photo.jpg")
    for frame in ("frame0", "frame1"):
        (src / frame).mkdir()
        for cam in CAMS:
            write_png(src / frame / f"{cam}.png", rng.integers(0, 256, (*FRAME, 3), dtype=np.uint8))
    config = tmp / "tiny.json"
    config.write_text(json.dumps(CFG))
    rate = _load_cli().main(["--input", str(src), "--output", str(out), "--config", str(config), "--batch", "4",
                             "--save-ply", "--save-panel", "--device", "cpu"])
    return src, out, rate


def test_output_names_follow_the_jax_cli(run):
    src, out, rate = run
    stems = ["assets_photo", "assets_rgb"] + [f"{f}_{c}" for f in ("frame0", "frame1") for c in CAMS]
    want = {f"{s}{tail}" for s in stems for tail in ("_depth.png", "_panel.png", ".ply")}
    assert {p.name for p in out.iterdir()} == want
    assert rate > 0


@pytest.fixture(scope="module")
def direct(run):
    """Each batch the CLI ran (sorted paths, grouped by size, 4 at a time)
    through ``infer()`` directly: path -> (image, depth, points)."""
    src, _, _ = run
    model = UniDepthV2.from_config(CFG, device="cpu").init_params(seed=0).eval()
    batches = [[src / "assets" / "photo.jpg", src / "assets" / "rgb.png"]]
    frames = sorted(src.glob("frame*/*.png"))
    batches += [frames[i : i + 4] for i in range(0, len(frames), 4)]
    found = {}
    for batch in batches:
        imgs = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in batch])
        out = model.infer(imgs)
        for j, p in enumerate(batch):
            found[p] = imgs[j], out["depth"][j, ..., 0].numpy(), out["points"][j].numpy()
    return found


def test_depth_pngs_equal_a_direct_infer(run, direct):
    src, out, _ = run
    for p, (img, depth, _) in direct.items():
        stem = "_".join(p.relative_to(src).with_suffix("").parts)
        got = read_png(out / f"{stem}_depth.png")
        assert got.dtype == np.uint16 and got.shape == img.shape[:2]
        want = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        assert np.abs(got.astype(np.int64) - want).max() <= 1


def test_ply_and_panel(run, direct, tmp_path):
    """The PLY has H * W coloured vertices, byte for byte what the JAX
    writer writes for a direct ``infer()``'s points; the panel is RGB |
    depth."""
    src, out, _ = run
    h, w = FRAME
    img, _, points = direct[src / "frame1" / "CAM_FRONT.png"]
    text = (out / "frame1_CAM_FRONT.ply").read_text()
    assert f"element vertex {h * w}\n" in text.split("end_header\n")[0]
    jax_save_point_cloud(str(tmp_path / "j.ply"), points.reshape(-1, 3), img.reshape(-1, 3))
    assert (tmp_path / "j.ply").read_text() == text
    panel = read_png(out / "frame1_CAM_FRONT_panel.png")
    assert panel.shape == (h, 2 * w, 3)
    np.testing.assert_array_equal(panel[:, :w], img)


def test_without_a_card_it_asks_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        _load_cli().main(["--input", str(tmp_path), "--output", str(tmp_path / "out")])

"""``scripts_torch/train.py`` on the CPU (``--device cpu``) with a small
config: two steps on Dummy data print finite loss lines and write a
checkpoint, which ``--resume`` continues from. UniDepthV1 (ConvNeXt) and
UniDepthV2old train two steps with their loss slots and write their
``MetricLogger`` stream and a training-artifact PNG."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

ROOT = Path(__file__).resolve().parents[1]


def _script():
    spec = importlib.util.spec_from_file_location("train_script", ROOT / "scripts_torch" / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tiny_config(tmp_path):
    cfg = json.loads((ROOT / "configs/config_v2_vitl14.json").read_text())
    cfg["model"]["num_heads"] = 2
    cfg["model"]["pixel_decoder"].update(hidden_dim=32, out_dim=16, depths=[1, 1, 1])
    cfg["model"]["pixel_encoder"].update(name="dinov2_vits14", embed_dim=32, depth=4, num_heads=2, pos_embed_size=4,
                                         output_idx=[1, 2, 3, 4])
    cfg["training"].update(batch_size=2, nsteps_accumulation_gradient=2, warmup_iters=2, n_iters=10)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return path


def _lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_two_steps_then_resume(tiny_config, tmp_path, capsys):
    train = _script()
    ckpt = tmp_path / "ckpt"
    common = ["--config-file", str(tiny_config), "--dummy-data", "--device", "cpu", "--image-shape", "30", "60",
              "--checkpoint-dir", str(ckpt)]
    saved = train.main([*common, "--steps", "2"])
    out = capsys.readouterr().out
    assert "(1 process)" in out
    lines = _lines(out)
    assert [line["step"] for line in lines] == [1, 2]
    for line in lines:
        assert {"depth", "camera", "invariance", "ssi", "confidence", "total", "grad_norm", "lr"} <= set(line)
        assert all(np.isfinite(v) for v in line.values())
    assert saved == ckpt / "step_00000002.pt" and saved.is_file()
    train.main([*common, "--steps", "3", "--resume", str(saved)])
    out = capsys.readouterr().out
    assert "at step 2" in out
    assert [line["step"] for line in _lines(out)] == [3]
    assert (ckpt / "step_00000003.pt").is_file()


def test_only_dummy_data_is_ported(tiny_config, tmp_path, monkeypatch):
    """Without a data root only ``--dummy-data`` trains: real datasets
    refuse with a message naming ``--data-root``, and a root that is not a
    directory is named."""
    monkeypatch.delenv("DATAROOT", raising=False)
    with pytest.raises(SystemExit, match="no data root: pass --data-root"):
        _script().main(["--config-file", str(tiny_config), "--device", "cpu"])
    with pytest.raises(SystemExit, match="is not a directory"):
        _script().main(["--config-file", str(tiny_config), "--device", "cpu", "--data-root", str(tmp_path / "none")])


def test_two_steps_on_hdf5_shards(tiny_config, tmp_path, capsys):
    """Two CPU steps over synthetic shards of KITTI, NYUv2Depth and ARKit
    (``--data-root``; the data root as ``DATAROOT`` too): the threaded
    Loader, a sampled shape a batch, validation on NYUv2Depth in test mode."""
    from unidepth_tpu_torch.datasets.synthetic import make_shards, write_hdf5

    write_hdf5(tmp_path, make_shards(["KITTI", "NYUv2Depth", "ARKit"], 4, 0,
                                     shapes={"KITTI": (356, 1222), "NYUv2Depth": (48, 64), "ARKit": (48, 64)}))
    cfg = json.loads(tiny_config.read_text())
    cfg["data"].update(train_datasets=["KITTI", "NYUv2Depth", "ARKit"], val_datasets=["NYUv2Depth"])
    cfg["data"]["augmentations"]["shape_constraints"].update(pixels_min=1200, pixels_max=4000)
    config = tmp_path / "tiny_data.json"
    config.write_text(json.dumps(cfg))
    ckpt = tmp_path / "ckpt"
    saved = _script().main(["--config-file", str(config), "--data-root", str(tmp_path), "--device", "cpu",
                            "--steps", "2", "--val-interval", "2", "--val-iters", "1", "--checkpoint-dir", str(ckpt)])
    out = capsys.readouterr().out
    assert "from ['KITTI', 'NYUv2Depth', 'ARKit']" in out and "shapes [(" in out
    lines = _lines(out)
    steps = [line for line in lines if "val" not in line]
    assert [line["step"] for line in steps] == [1, 2]
    assert all(np.isfinite(v) for line in steps for v in line.values())
    val = next(line["val"]["NYUv2Depth"] for line in lines if "val" in line)
    assert all(np.isfinite(v) for v in val.values())
    assert saved == ckpt / "step_00000002.pt" and saved.is_file()
    records = [json.loads(line) for line in (ckpt / "tiny_data.jsonl").read_text().splitlines()]
    assert any("image/NYUv2Depth_training" in r for r in records)


def test_no_device_and_no_card_raises(tiny_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        _script().main(["--config-file", str(tiny_config), "--dummy-data"])


FAMILY_CONFIGS = {  # shipped config, encoder overrides, image shape
    "v1-convnext": ("config_v1_cnvnxtl.json", {"depths": [1, 1, 2, 1], "dims": [32, 64, 128, 256]}, ("64", "96")),
    "v2old": ("config_v2old_vitl14.json", {"name": "dinov2_vits14", "embed_dim": 32, "depth": 4, "num_heads": 2,
                                           "pos_embed_size": 4, "output_idx": [1, 2, 3, 4]}, ("28", "56")),
}


@pytest.mark.parametrize("family", list(FAMILY_CONFIGS))
def test_two_steps_each_family(family, tmp_path, capsys):
    from unidepth_tpu_torch.utils.png import read_png

    shipped, encoder, shape = FAMILY_CONFIGS[family]
    cfg = json.loads((ROOT / "configs" / shipped).read_text())
    cfg["model"]["num_heads"] = 2
    cfg["model"]["pixel_decoder"].update(hidden_dim=32, depths=[1, 1, 1])
    cfg["model"]["pixel_encoder"].update(encoder)
    cfg["training"].update(batch_size=2, nsteps_accumulation_gradient=2, warmup_iters=2, n_iters=10)
    config = tmp_path / f"tiny_{family}.json"
    config.write_text(json.dumps(cfg))
    ckpt = tmp_path / "ckpt"
    saved = _script().main(["--config-file", str(config), "--dummy-data", "--device", "cpu", "--image-shape", *shape,
                            "--checkpoint-dir", str(ckpt), "--steps", "2"])
    out = capsys.readouterr().out
    assert f"training {cfg['model']['name']} " in out and "(1 process)" in out
    slots = {"depth", "camera", "invariance", "total"} | ({"ssi", "confidence"} if family == "v2old" else set())
    lines = _lines(out)
    assert [line["step"] for line in lines] == [1, 2]
    for line in lines:
        assert set(line) == slots | {"step", "grad_norm", "lr", "seconds"}
        assert all(np.isfinite(v) for v in line.values())
    assert saved == ckpt / "step_00000002.pt" and saved.is_file()
    records = [json.loads(line) for line in (ckpt / f"tiny_{family}.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/total" in r] == [1, 2]
    image = next(r["image/Dummy_training"] for r in records if "image/Dummy_training" in r)
    grid = read_png(image)
    h, w = (int(s) // 14 * 14 for s in shape)  # the training shape, floored to the patch size
    assert grid.dtype == np.uint8 and grid.shape == (3 * h, 2 * w, 3)  # rgb, GT, prediction; two samples
    assert any("sys/host_rss_kb" in r for r in records)

"""``scripts_torch/train.py`` on the CPU (``--device cpu``) with a small
config: two steps on Dummy data print finite loss lines and write a
checkpoint, which ``--resume`` continues from."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

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
    assert "no sharding" in out
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


def test_only_dummy_data_is_ported(tiny_config):
    with pytest.raises(SystemExit, match="A8"):
        _script().main(["--config-file", str(tiny_config), "--device", "cpu"])


def test_no_device_and_no_card_raises(tiny_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        _script().main(["--config-file", str(tiny_config), "--dummy-data"])

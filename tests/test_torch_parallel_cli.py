"""``scripts_torch/train.py`` on two CPU processes, the counterpart of
tests/test_train_rehearsal.py: ``python -m torch.distributed.run
--standalone --nproc_per_node 2`` (the rendezvous on a free port the OS
picks) with ``--device cpu --fsdp 2``, a tiny UniDepthV2, Dummy data, 4 x 2
images a step (accumulation 2, 2 images a rank a micro-batch), one
validation at step 2 and checkpoints at steps 2 and 3.

A run of 3 steps, then a run that resumes from its step-2 checkpoint and
takes step 3: the two step-3 checkpoints are equal bit for bit. Only rank 0
prints and writes. The step-2 checkpoint, written at fsdp=2, resumes in one
process as well."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch_threads  # noqa: F401  (sets this process's torch thread count)

ROOT = Path(__file__).resolve().parents[1]


def _config(tmp_path) -> Path:
    cfg = json.loads((ROOT / "configs/config_v2_vitl14.json").read_text())
    cfg["model"]["num_heads"] = 2
    cfg["model"]["pixel_decoder"].update(hidden_dim=32, out_dim=16, depths=[1, 1, 1])
    cfg["model"]["pixel_encoder"].update(name="dinov2_vits14", embed_dim=32, depth=4, num_heads=2, pos_embed_size=4,
                                         output_idx=[1, 2, 3, 4])
    cfg["training"].update(batch_size=4, nsteps_accumulation_gradient=2, warmup_iters=2, n_iters=10,
                           checkpoint_interval=2)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    return path


def _torchrun(tmp_path, ckpt, *extra) -> str:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           str(ROOT / "scripts_torch" / "train.py"), "--config-file", str(_config(tmp_path)), "--dummy-data",
           "--device", "cpu", "--fsdp", "2", "--image-shape", "28", "56", "--checkpoint-dir", str(ckpt), *extra]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _lines(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_fsdp2_run_resumes_exactly_and_loads_in_one_process(tmp_path, capsys):
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    out = _torchrun(tmp_path, straight, "--steps", "3", "--val-interval", "2", "--val-iters", "1")
    assert "2 processes (gloo), mesh data 1 x fsdp 2 x tp 1, 2 images a rank" in out
    assert out.count("training UniDepthV2") == 1  # rank 0 alone prints
    lines = _lines(out)
    steps = [line for line in lines if "val" not in line]
    assert [line["step"] for line in steps] == [1, 2, 3]
    assert all(np.isfinite(v) for line in steps for v in line.values())
    val = next(line["val"]["Dummy"] for line in lines if "val" in line)
    assert all(np.isfinite(v) for v in val.values())
    assert sorted(p.name for p in straight.glob("*.pt")) == ["step_00000002.pt", "step_00000003.pt"]
    records = [json.loads(line) for line in (straight / "tiny.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/total" in r] == [1, 2, 3]
    assert any("image/Dummy_training" in r for r in records)

    out = _torchrun(tmp_path, resumed, "--steps", "3", "--resume", str(straight / "step_00000002.pt"))
    assert "at step 2" in out and [line["step"] for line in _lines(out)] == [3]
    a = torch.load(straight / "step_00000003.pt", weights_only=True)
    b = torch.load(resumed / "step_00000003.pt", weights_only=True)
    assert a["step"] == b["step"] == 3 and a["opt"]["count"] == b["opt"]["count"] == 3
    for tree in (lambda s: s["params"], lambda s: s["opt"]["mu"], lambda s: s["opt"]["nu"], lambda s: s["ema"]["shadow"]):
        ta, tb = tree(a), tree(b)
        assert list(ta) == list(tb)
        for n in ta:
            assert torch.equal(ta[n], tb[n]), n

    import importlib.util

    spec = importlib.util.spec_from_file_location("train_script", ROOT / "scripts_torch" / "train.py")
    train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train)
    saved = train.main(["--config-file", str(tmp_path / "tiny.json"), "--dummy-data", "--device", "cpu",
                        "--image-shape", "28", "56", "--checkpoint-dir", str(tmp_path / "single"), "--steps", "3",
                        "--resume", str(straight / "step_00000002.pt")])
    out = capsys.readouterr().out
    assert "at step 2" in out and "(1 process)" in out
    one, two = torch.load(saved, weights_only=True), torch.load(straight / "step_00000002.pt", weights_only=True)
    assert one["step"] == 3 and one["opt"]["count"] == 3
    assert all(torch.isfinite(one["params"][n]).all() for n in one["params"])
    assert any(not torch.equal(one["params"][n], two["params"][n]) for n in two["params"])

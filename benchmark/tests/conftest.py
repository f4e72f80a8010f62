"""Fixtures of the benchmark's own tests: a checkout root holding tiny
cells (ViT of width 32 and ConvNeXt of widths 32-256, 2-image batches) that
run on the CPU with the kernels' plain versions."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_LIMITS = {"depth_mean_rel": 1e-3, "confidence_mean_rel": 1e-3, "intrinsics_max_rel": 1e-3}


def tiny_v2(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["model"]["pixel_encoder"].update(embed_dim=32, depth=4, num_heads=2, pos_embed_size=4, output_idx=[1, 2, 3, 4])
    c["model"]["pixel_decoder"].update(hidden_dim=32, depths=[1, 1, 1], out_dim=8)
    c["model"]["num_heads"] = 2
    c["data"]["augmentations"]["shape_constraints"].update(pixels_min=1000, pixels_max=4000)
    return c


def tiny_v1(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["model"]["pixel_encoder"].update(depths=[1, 1, 2, 1], dims=[32, 64, 128, 256])
    c["model"]["pixel_decoder"].update(hidden_dim=32, depths=[1, 1, 1])
    c["model"]["num_heads"] = 2
    c["data"]["image_shape"] = [64, 96]
    return c


TINY = {
    "tiny-v2.serve": ("v2-vitl14", tiny_v2, [[56, 70], [40, 110]]),
    "tiny-v1.serve": ("v1-cnvnxtl", tiny_v1, [[50, 90]]),
}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def make_root(tmp: Path) -> Path:
    """A checkout root with the repository's manifest and metric readers and
    the tiny cells, which every declared metric lists."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            m["workloads"] = m.get("workloads", []) + list(TINY)
    write_json(tmp / "BENCHMARK.json", manifest)
    (tmp / "benchmark").mkdir(parents=True, exist_ok=True)
    (tmp / "benchmark" / "metrics").symlink_to(ROOT / "benchmark" / "metrics")
    for cell, (base, shrink, cameras) in TINY.items():
        src = json.loads((ROOT / "benchmark" / "configs" / f"{base}.json").read_text())
        name = cell.split(".")[0]
        write_json(tmp / "benchmark" / "configs" / f"{name}.json",
                   {**src, "config": shrink(src["config"]), "dtype": "float32"})
        write_json(tmp / "benchmark" / "traffic" / f"{name}.json", {
            "kind": "closed_loop", "clients": 1, "batch": 2,
            "cameras": [{"hw": hw, "share": 1} for hw in cameras],
            "pool_batches": 2, "check": {"per_camera": 2, "among_first": 3}})
        write_json(tmp / "benchmark" / "workloads" / f"{cell}.json", {
            "config": name, "traffic": name, "chips": 1, "why": "a CPU test",
            "limits": {k: v for k, v in TINY_LIMITS.items() if base.startswith("v2") or "confidence" not in k}})
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)

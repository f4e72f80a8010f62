"""The correctness check fails what it must: the control (the reference in
fp8 in the program's place) and the faults a serving cell can have, each at
a size a test run holds, against the real cells' limits."""

from __future__ import annotations

import json
import re
import time

import pytest
import torch
from conftest import ROOT, TINY, write_json

from benchmark.harness import check, registry, session, weights

#: every cell file, those BENCHMARK.json does not list yet too
CELLS = sorted(p.stem for p in (ROOT / "benchmark" / "workloads").glob("*.json"))
TINY_OF_CONFIG = {base: cell for cell, (base, _, _) in TINY.items()}


def _real_limits(cell: str) -> dict:
    return registry.cell(ROOT, cell)["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cell(cell):
    """The fp8 reference, against the float32 one on the tiny configuration
    of the cell's family, fails one of the cell's limits on each seed."""
    real = registry.cell(ROOT, cell)
    base, shrink, cameras = TINY[TINY_OF_CONFIG[real["config"]]]
    fam = registry.family(real["config_file"]["family"])
    config = shrink(real["config_file"]["config"])
    model = fam.build(config, "cpu", torch.float32)
    assumed = real["config_file"]["assumed"]
    entries = weights.spec(model, assumed["layer_scale"], assumed.get("weight_scales"))
    for seed in (1, 2, 3):
        values = weights.draw(entries, seed, "cpu")
        sampled = []
        for hw in cameras:
            rgb = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(seed))
            sampled.append((rgb, {}))
        got = check.numbers(fam, config, values, sampled, torch.device("cpu"), fp8=True)
        assert any(got[name] > limit for name, limit in real["limits"].items()), (seed, got, real["limits"])


def _alter_one_answer(serve):
    def broken(model, rgb):
        out = dict(serve(model, rgb))
        out["depth"] = out["depth"].clone()
        out["depth"][0] *= 1.5
        return out
    return broken


def _half_batch(serve):
    def broken(model, rgb):
        out = serve(model, rgb[: rgb.shape[0] // 2])
        return {k: torch.cat([v, v]) if torch.is_tensor(v) and v.ndim else v for k, v in out.items()}
    return broken


def _with_real_limits(root, tiny_cell: str, real_cell: str) -> None:
    path = root / "benchmark" / "workloads" / f"{tiny_cell}.json"
    write_json(path, {**json.loads(path.read_text()), "limits": _real_limits(real_cell)})


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, _alter_one_answer, _half_batch, "control"])
def test_faults_fail_the_run(tiny_root, cell, fault):
    """A whole run on the tiny configuration of the cell's family, the chip
    check skipped: sound it is correct; with a fault underneath, or the
    control served in the program's place, every sampled request arrives
    and a number is over the cell's limit."""
    tiny_cell = TINY_OF_CONFIG[registry.cell(ROOT, cell)["config"]]
    _with_real_limits(tiny_root, tiny_cell, cell)
    if fault == "control":
        fault = check.control(tiny_root, tiny_cell, 9)
    result, lines = session.run(tiny_root, tiny_cell, 9, 0.3, False, "cpu", time.perf_counter(), fault=fault)
    assert result["correct"] is (fault is None), lines
    sampled = next(line for line in lines if line.startswith("check sampled requests:"))
    got, due = re.fullmatch(r"check sampled requests: (\d+) \(due (\d+)\)", sampled).groups()
    assert got == due, lines
    assert any(c["value"] > c["limit"] for c in result["checks"].values()) is (fault is not None), lines

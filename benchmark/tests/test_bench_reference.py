"""The plain references against the port's float32 plain path at tiny
sizes on the CPU, on the same weights and uint8 images, and the references'
isolation from the port."""

from __future__ import annotations

import ast
import json

import pytest
import torch
from conftest import ROOT, tiny_v1, tiny_v2

from benchmark.harness import weights
from benchmark.harness.registry import family
from benchmark.reference.ops import Numerics

CASES = [
    ("unidepth_v2", "v2-vitl14", tiny_v2, (56, 70)),  # in the aspect bounds
    ("unidepth_v2", "v2-vitl14", tiny_v2, (40, 110)),  # too wide: padded, resized
    ("unidepth_v1", "v1-cnvnxtl", tiny_v1, (64, 96)),  # the network shape
    ("unidepth_v1", "v1-cnvnxtl", tiny_v1, (50, 90)),  # fitted, padded
]


@pytest.mark.parametrize("fam_name,config_name,shrink,hw", CASES)
def test_reference_matches_port_plain_fp32(fam_name, config_name, shrink, hw):
    fam = family(fam_name)
    config = shrink(json.loads((ROOT / "benchmark" / "configs" / f"{config_name}.json").read_text())["config"])
    model = fam.build(config, "cpu", torch.float32)
    values = weights.draw(weights.spec(model, 1.0), 5, "cpu")
    weights.load(model, values)
    rgb = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = fam.infer_reference(Numerics(), values, config, rgb)
    out = fam.serve(model, rgb)
    for key in fam.CHECKED_OUTPUTS:
        assert out[key].shape == ref[key].shape, key
        torch.testing.assert_close(out[key].float(), ref[key], rtol=1e-4, atol=1e-5, msg=key)


def test_references_import_nothing_of_the_program():
    allowed = {"__future__", "dataclasses", "math", "numpy", "torch"}
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            assert {n.split(".")[0] for n in names} <= allowed, (path.name, names)

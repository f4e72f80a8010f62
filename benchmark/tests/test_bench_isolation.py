"""No module a run loads is JAX or the JAX package, compared by whole
top-level names."""

from __future__ import annotations

import subprocess
import sys

from conftest import ROOT

from benchmark.harness.isolation import forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["unidepth_tpu_torch", "unidepth_tpu_torch.ops._cuda", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["unidepth_tpu.models.unidepthv2", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "unidepth_tpu"]


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole tiny run on the CPU, in a fresh process, then the check."""
    script = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(ROOT / 'benchmark' / 'tests')!r})
from pathlib import Path
import conftest
from benchmark.harness import isolation, session
root = conftest.make_root(Path({str(tmp_path)!r}))
result, _ = session.run(root, "tiny-v2.serve", 3, 0.2, False, "cpu", time.perf_counter())
assert result["correct"], result
print("forbidden", isolation.forbidden_modules())
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "forbidden []"

"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files only are found by name and run; the manifest agrees with the cell
files."""

from __future__ import annotations

import json
import time

from conftest import ROOT, write_json

from benchmark.harness import registry, session


def test_new_files_are_found_by_name(tiny_root):
    root = tiny_root
    # a new configuration, traffic mix and cell: copies under new names
    write_json(root / "benchmark" / "configs" / "tiny-v2b.json",
               json.loads((root / "benchmark" / "configs" / "tiny-v2.json").read_text()))
    mix = json.loads((root / "benchmark" / "traffic" / "tiny-v2.json").read_text())
    write_json(root / "benchmark" / "traffic" / "tiny-wide.json", {**mix, "cameras": [{"hw": [30, 140], "share": 2}]})
    cell = json.loads((root / "benchmark" / "workloads" / "tiny-v2.serve.json").read_text())
    write_json(root / "benchmark" / "workloads" / "tiny-v2b.wide.json", {**cell, "config": "tiny-v2b",
                                                                         "traffic": "tiny-wide"})
    # a new per-layer metric: a reader file and a manifest entry
    (root / "benchmark" / "metrics").unlink()
    (root / "benchmark" / "metrics").mkdir()
    (root / "benchmark" / "metrics" / "requests_seen.serve.py").write_text(
        "def read(record):\n    return float(len(record['requests']))\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["per_layer"] = [{"name": "requests_seen.serve", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "entry", "moves": "images_per_s",
                              "workloads": ["tiny-v2b.wide"]}]
    for m in manifest["end_to_end"]:
        m["workloads"].append("tiny-v2b.wide")
    write_json(root / "BENCHMARK.json", manifest)

    loaded = registry.cell(root, "tiny-v2b.wide")
    assert loaded["traffic_mix"]["cameras"] == [{"hw": [30, 140], "share": 2}]
    assert registry.per_layer(root, "tiny-v2b.wide") == ["requests_seen.serve"]
    assert registry.per_layer(root, "tiny-v2.serve") == []
    result, _ = session.run(root, "tiny-v2b.wide", 11, 0.3, False, "cpu", time.perf_counter())
    assert result["correct"] and set(result["metrics"]) == {m["name"] for m in manifest["end_to_end"]}
    served = session.Session(root, "tiny-v2b.wide", "cpu")
    served.prepare(11)
    record = served.window(10.0, False)["record"]  # long enough to complete requests on a loaded CPU
    assert registry.reader(root, "requests_seen.serve")(record) == len(record["requests"]) > 0


def test_manifest_matches_cell_files():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        cell = registry.cell(ROOT, w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"], w["chips"])
        assert configs[w["config"]]["file"] == f"benchmark/configs/{w['config']}.json"
        assert cell["config_file"]["reduced"] == configs[w["config"]]["reduced"]
        for m in manifest["per_layer"]:
            if w["name"] in m["workloads"]:
                assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()

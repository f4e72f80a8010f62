"""Everything a run needs, found by name under the checkout's root:

* a cell: ``benchmark/workloads/<name>.json`` (``config``, ``traffic``,
  ``chips``, ``why`` and the correctness ``limits``);
* a configuration: ``benchmark/configs/<name>.json`` (the model config as
  run, its ``family``, source, ``reduced``, ``assumed`` and ``dtype``);
  its family, ``benchmark/families/<family>.py``, builds the program and
  holds the plain reference;
* a traffic mix: ``benchmark/traffic/<name>.json``, read by
  ``harness/traffic.py``;
* a per-layer metric: ``benchmark/metrics/<name>.py``, whose ``read(record)``
  returns the metric's value or None; which of them a cell reports is
  ``BENCHMARK.json``'s ``per_layer`` list.

New cells, configurations, mixes and metrics are new files (and entries in
``BENCHMARK.json``): nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def _checked(name: str) -> str:
    if not name or len(name) > 64 or not set(name) <= NAME_CHARS or name[0] in ".-":
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: Path, name: str) -> dict:
    """The cell ``name`` with its configuration and traffic loaded."""
    c = _json(root / "benchmark" / "workloads" / f"{_checked(name)}.json")
    config = _json(root / "benchmark" / "configs" / f"{_checked(c['config'])}.json")
    traffic = _json(root / "benchmark" / "traffic" / f"{_checked(c['traffic'])}.json")
    return {**c, "name": name, "config_file": config, "traffic_mix": traffic}


def family(name: str):
    """The family module ``benchmark/families/<name>.py``."""
    return importlib.import_module(f"benchmark.families.{_checked(name)}")


def _declared(root: Path, kind: str, cell_name: str) -> list[str]:
    manifest = _json(root / "BENCHMARK.json")
    return [m["name"] for m in manifest[kind] if cell_name in m.get("workloads", [cell_name])]


def end_to_end(root: Path, cell_name: str) -> list[str]:
    """The end-to-end metrics ``BENCHMARK.json`` declares for ``cell_name``."""
    return _declared(root, "end_to_end", cell_name)


def per_layer(root: Path, cell_name: str) -> list[str]:
    """The per-layer metrics ``BENCHMARK.json`` declares for ``cell_name``."""
    return _declared(root, "per_layer", cell_name)


def metric_units(root: Path) -> dict:
    """Every declared metric's unit, by name."""
    manifest = _json(root / "BENCHMARK.json")
    return {m["name"]: m["unit"] for kind in ("end_to_end", "per_layer") for m in manifest[kind]}


def reader(root: Path, metric: str):
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{_checked(metric)}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

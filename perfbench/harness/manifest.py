"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, ``perfbench/workloads/<cell>.json``, ``perfbench/configs/<config>.json``,
``perfbench/traffic/<kind>.py`` and ``perfbench/metrics/<metric>.py``. A
later cell, configuration, traffic kind or metric is a new file here and a
new entry in ``BENCHMARK.json``; nothing of this module changes."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(root: Path, bench: dict, name: str) -> dict:
    """The cell's entry in ``BENCHMARK.json`` merged with its workload file
    (traffic parameters, limits)."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    spec = _json(root / "perfbench" / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec.get(key) != entries[0][key]:
            raise SystemExit(f"perfbench: workloads/{name}.json says {key}={spec.get(key)!r}, "
                             f"BENCHMARK.json {entries[0][key]!r}")
    return {**spec, **entries[0]}


def config(root: Path, bench: dict, name: str) -> dict:
    entry = [c for c in bench["configs"] if c["name"] == name]
    if not entry:
        raise SystemExit(f"perfbench: no configuration {name!r} in BENCHMARK.json")
    return _json(root / entry[0]["file"])


def load_module(path: Path):
    """Import the file at ``path`` under a name of its own (file names may
    hold dots, as metric names do)."""
    name = "perfbench_file_" + "_".join(path.relative_to(path.parents[1]).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def traffic(root: Path, kind: str):
    return load_module(root / "perfbench" / "traffic" / f"{kind}.py")


def metric(root: Path, name: str):
    return load_module(root / "perfbench" / "metrics" / f"{name}.py")


def cell_metrics(bench: dict, cell_name: str, traced: bool) -> list:
    """The metric entries a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced. An entry with ``workloads``
    applies to the cells listed; an end-to-end metric without it to every
    cell; a per-layer metric without it to every cell reporting the metric
    it moves."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in moved:
            out.append(m)
    return out

"""BENCHMARK.json against the benchmark's contract, every name found as a
file, and the import guard: no module of the benchmark imports JAX or the
JAX package, and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import re

import pytest
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "gan_class_transfer2_tpu"}
PROGRAM = "gan_class_transfer2_tpu_torch"


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"]) and _line(entry["why"])
    assert entry["source"].startswith("https://")
    assert entry["file"].startswith("perfbench/") and (ROOT / entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    fields = json.loads((ROOT / entry["file"]).read_text())
    assert fields["source"] == entry["source"] and fields["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(entry["file"]) == 1


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"]) and _line(entry["why"])
    assert entry["chips"] in (1, 4)
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    assert (ROOT / "perfbench" / "traffic" / f"{entry['traffic']}.py").is_file()
    spec = json.loads((ROOT / "perfbench" / "workloads" / f"{entry['name']}.json").read_text())
    assert {k: spec[k] for k in ("name", "config", "traffic", "chips")} == {
        k: entry[k] for k in ("name", "config", "traffic", "chips")}
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if entry["name"] in m.get("workloads", [entry["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in BENCH["per_layer"] if entry["name"] in m.get("workloads", [])
           or ("workloads" not in m and m["moves"] in e2e)]
    assert per


def test_names_are_unique_and_pairs_appear_once():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", [])) <= names
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(m["layer"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for w in m.get("workloads", []):
        assert w in e2e[m["moves"]].get("workloads", [w])
    assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    if "_roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in (ROOT / "perfbench").rglob("*.py") if "out" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(_imports(path))
    assert not names & FORBIDDEN
    if "reference" in path.relative_to(ROOT / "perfbench").parts:
        assert PROGRAM not in names and "perfbench" not in names


def test_guard_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    from perfbench.harness import session

    monkeypatch.setitem(sys.modules, "gan_class_transfer2_tpu_torch_probe", types.ModuleType("x"))
    assert session.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert session.loaded_forbidden() == ["jax"]

"""Fixtures of the benchmark's CPU tests: the checkout's root on the path, and
``tiny_root``, a copy of the benchmark in a temporary directory with a tiny
configuration and a tiny cell beside each real one, added as files and
``BENCHMARK.json`` entries alone, as a later change would add them."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(size=16, pixel_size=4, max_size=8, octaves=2, steps=4)


def make_tiny_root(tmp: Path, dtype: str = "float32", limits: dict = None) -> Path:
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in list(bench["configs"]):
        c = json.loads((ROOT / entry["file"]).read_text())
        c.update(TINY, compute_dtype=dtype)
        name = "tiny-" + entry["name"]
        path = f"perfbench/configs/{name}.json"
        (tmp / path).write_text(json.dumps(c))
        bench["configs"].append({**entry, "name": name, "file": path})
    for w in list(bench["workloads"]):
        spec = json.loads((ROOT / "perfbench" / "workloads" / f"{w['name']}.json").read_text())
        name, config = "tiny-" + w["name"], "tiny-" + w["config"]
        spec.update(name=name, config=config)
        p = spec["params"]
        p["batch"] = 2 * w["chips"]
        if "pool" in p:
            p.update(pool=4 * p["batch"], pool_side=20)
        if "ref_block" in p:
            p["ref_block"] = 1
        if limits:
            spec["limits"] = {k: limits.get(k, v) for k, v in spec["limits"].items()}
        (tmp / "perfbench" / "workloads" / f"{name}.json").write_text(json.dumps(spec))
        bench["workloads"].append({**w, "name": name, "config": config})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


def last_json_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])

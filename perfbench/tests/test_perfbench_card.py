"""On the card: each cell once, at its own size, through the command line,
down to a correct result line (``python -m pytest perfbench/tests -m cuda``).
Skips without the cards the cell asks for."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT, last_json_line

CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c["name"])
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        pytest.skip(f"needs {cell['chips']} NVIDIA card(s)")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell["name"],
                           "--seed", "2147483999", "--seconds", "2", "--trace", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = last_json_line(proc.stdout)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0

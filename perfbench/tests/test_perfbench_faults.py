"""The comparison fails what it must, at a tiny size on the CPU with each
cell's own limits: the control (the reference one precision below the
configuration's, in the program's place) and each fault the cell can have,
planted under a whole run of the harness, whose ``correct`` comes out
false."""

from __future__ import annotations

import json

import pytest
from conftest import ROOT, last_json_line, make_tiny_root

from perfbench import calibrate, faults, run
from perfbench.harness import manifest

WORKLOADS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
CASES = [(w["name"], w["traffic"], f) for w in WORKLOADS for f in faults.KINDS[w["traffic"]]]


@pytest.mark.parametrize("cell,kind,fault", CASES, ids=lambda c: str(c))
def test_a_planted_fault_makes_the_run_incorrect(tiny_root, cell, kind, fault, capsys,
                                                 monkeypatch):
    traffic = manifest.traffic(tiny_root, kind)
    if hasattr(traffic, "launch"):  # ranks of their own: the fault goes to each
        orig = traffic.launch
        monkeypatch.setattr(traffic, "launch",
                            lambda r, mode, seeds, _="": orig(r, mode, seeds, fault))
    with faults.FAULTS[fault](kind):
        rc = run.main(["--workload", f"tiny-{cell}", "--seed", "7", "--seconds", "0.2",
                       "--trace", "0"], root=tiny_root, device="cpu")
    assert rc == 0
    line = last_json_line(capsys.readouterr().out)
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.parametrize("cell", [w["name"] for w in WORKLOADS if w["chips"] == 1])
def test_the_control_fails_a_limit(tmp_path, cell, capsys):
    """The bfloat16 tiny cell with the cell's limits: the fp8 control in the
    program's place fails one of them, on three seeds. (Limits are set at
    the cell's size, where the program passes them; the tiny float32 cells
    of the rehearsal pass them too.)"""
    root = make_tiny_root(tmp_path, dtype="bfloat16")
    limits = json.loads((ROOT / "perfbench/workloads" / f"{cell}.json").read_text())["limits"]
    for row in calibrate.readings(f"tiny-{cell}", ["control"], [1, 2, 3], root=root, device="cpu"):
        assert any(row[k] > v for k, v in limits.items()), (row, limits)
    capsys.readouterr()

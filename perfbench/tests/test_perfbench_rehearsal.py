"""Every traffic driver at a tiny size on the CPU through the program's plain
paths, down to the last line: set-up, window, reference, readers, result.
The cells are the tiny ones ``tiny_root`` adds as files beside the real
ones, so these runs also show that the harness finds a cell by its files."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import ROOT, last_json_line

from perfbench import run

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_a_correct_result(tiny_root, cell, trace, capsys):
    rc = run.main(["--workload", f"tiny-{cell}", "--seed", str(2**31 + 17), "--seconds", "0.5",
                   "--trace", str(trace)], root=tiny_root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    line = last_json_line(out)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"]["platform"] == "cpu"
    names = [ln.split()[1] for ln in err.strip().splitlines()[-len(line["checks"]):]]
    assert names == list(line["checks"])
    if trace:
        assert "busy_s" in line["device"] and "breakdown" in line
    else:
        assert "setup_s" in line["metrics"] and line["metrics"]["setup_s"]["value"] > 0
        assert len(line["metrics"]) == 2  # setup_s and the cell's rate


def test_same_seed_same_inputs(tiny_root, capsys):
    checks = []
    for _ in range(2):
        run.main(["--workload", "tiny-ddpm256-train-bf16-b256", "--seed", "5", "--seconds", "0.2",
                  "--trace", "0"], root=tiny_root, device="cpu")
        checks.append(last_json_line(capsys.readouterr().out)["checks"])
    assert checks[0] == checks[1]


def test_no_card_no_result():
    """The command line takes the card; without one it exits non-zero and
    prints no result line."""
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "ddpm256-sample-bf16-b16", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's paths
    (no program), a run exits non-zero without a result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "ddpm256-sample-bf16-b16", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


PLANTED = '''
_unit = _Driver.unit


def _planted(self):  # the JAX package loaded inside a rank, in its window
    import jax  # noqa: F401

    _unit(self)


_Driver.unit = _planted


'''


def test_a_rank_that_loads_jax_in_its_window_gives_no_result(tiny_root, monkeypatch, capsys):
    """Each rank reads its modules once its window and checks are over: an
    import that a rank makes in the window withholds the result."""
    (tiny_root / "jax").mkdir()
    (tiny_root / "jax" / "__init__.py").write_text("")
    path = tiny_root / "perfbench" / "traffic" / "train_dp.py"
    main = 'if __name__ == "__main__":'
    path.write_text(path.read_text().replace(main, PLANTED + main))
    for name in [m for m in sys.modules if m.startswith("perfbench_file_")]:
        monkeypatch.delitem(sys.modules, name)  # the planted copy, not one loaded before
    cell = next(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                if w["traffic"] == "train_dp")
    with pytest.raises(RuntimeError, match="forbidden modules loaded in the ranks: \\['jax'\\]"):
        run.main(["--workload", f"tiny-{cell}", "--seed", "11", "--seconds", "0.2", "--trace", "0"],
                 root=tiny_root, device="cpu")
    assert '"correct"' not in capsys.readouterr().out


def test_forbidden_module_withholds_the_result(monkeypatch, capsys):
    import types

    from perfbench.harness import session

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    rc = session.emit({"correct": True, "checks": {}})
    assert rc != 0 and '"correct"' not in capsys.readouterr().out

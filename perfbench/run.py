#!/usr/bin/env python3
"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` the same
window under ``torch.profiler`` and the cell's per-layer metrics. Every run
compares what the timed path produced with the plain reference under
``perfbench/reference`` and prints each number compared beside its limit.
Without the cards the cell asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PROGRAM = "gan_class_transfer2_tpu_torch"


def _env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    out = root / "perfbench" / "out"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(out / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(out / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, root: Path = ROOT, device: str | None = None) -> int:
    """``device``: None takes the cards and requires them; the tests pass
    ``"cpu"`` to rehearse a run at a tiny size."""
    from perfbench.harness import session

    t0 = session.process_start()
    args = parse(argv)
    _env(root)
    from perfbench.harness import manifest

    bench = manifest.benchmark(root)
    cell = manifest.cell(root, bench, args.workload)
    config = manifest.config(root, bench, cell["config"])
    traffic = manifest.traffic(root, cell["traffic"])

    import torch

    from perfbench.harness import device as dev_lib

    if device is None:
        import importlib

        program = Path(importlib.import_module(PROGRAM).__file__).resolve()
        if root.resolve() not in program.parents:
            print(f"perfbench: the program under test must be the checkout's {PROGRAM}, "
                  f"found {program}; no result", file=sys.stderr)
            return 2
        dev_lib.require_cards(cell["chips"])
        print(f"perfbench: card {dev_lib.power_limit()}, torch {torch.__version__}",
              file=sys.stderr)
        dev = torch.device("cuda", 0)
        torch.cuda.init()
    else:
        dev = torch.device(device)
    run = session.Run(args, root, bench, cell, config, dev, t0)
    run.phase("imports and the card")
    if hasattr(traffic, "main"):
        line = traffic.main(run)
    else:
        session.run_single(run, traffic)
        info = dev_lib.info(dev, cell["chips"])
        info["memory_peak_bytes"] = run.memory_peak
        if run.tracer is not None:
            info["busy_s"] = run.tracer.busy_s()
            info["window_s"] = run.window_s
        line = session.result(run, session.read_metrics(run, manifest), info)
    return session.emit(line)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())

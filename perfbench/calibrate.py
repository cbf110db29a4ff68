#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's own
size, with no measured window: in one process, for each seed, the checks of

  * ``program``: the program as the cell runs it (the lower readings);
  * ``control``: the plain reference computed one precision below the
    configuration's (``reference/lowp.py``) in the program's place;
  * ``fault:<name>``: the program with a fault of ``faults.py`` planted.

    python3 perfbench/calibrate.py --workload <cell> --modes program control \\
        fault:half_batch --seeds 11 12 13 [--out perfbench/out/cal.jsonl]

Each reading is a JSON line on stdout (and in ``--out``); no run of
``run.py`` runs this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worst_leaves(got, ref, n=3):
    """The leaves with the largest gaps, for the look at what a number reads."""
    from perfbench.harness import compare

    out = {"losses": [got.losses, ref.losses]}
    moved = compare.moved_leaves(ref.grad_norms)
    for what, a, b, k in (("grad", got.grad_norms, ref.grad_norms, moved),
                          ("delta", got.delta_norms, ref.delta_norms,
                           moved & compare.resolved_leaves(ref))):
        gaps = compare.leaf_gaps(a, b, k)
        out[what] = [[name, gaps[name], a.get(name), b[name]]
                     for name in sorted(gaps, key=gaps.get, reverse=True)[:n]]
    return out


def readings(workload, modes, seeds, root=ROOT, device=None, out=None):
    import torch

    from perfbench import faults
    from perfbench.harness import manifest, session
    from perfbench.reference import lowp

    bench = manifest.benchmark(root)
    cell = manifest.cell(root, bench, workload)
    config = manifest.config(root, bench, cell["config"])
    traffic = manifest.traffic(root, cell["traffic"])
    dev = torch.device(device or "cuda")
    rows = []
    for mode in modes:
        many = None
        if mode != "control" and hasattr(traffic, "calibrate_many"):
            args = argparse.Namespace(seed=seeds[0], seconds=0, trace=0)
            run = session.Run(args, root, bench, cell, config, dev, time.time())
            many = dict(zip(seeds, traffic.calibrate_many(
                run, seeds, mode[6:] if mode.startswith("fault:") else "")))
        for seed in seeds:
            args = argparse.Namespace(seed=seed, seconds=0, trace=0)
            run = session.Run(args, root, bench, cell, config, dev, time.time())
            t0 = time.time()
            if many is not None:
                checks = many[seed]
            elif mode == "program":
                checks = traffic.calibrate(run)
            elif mode == "control":
                below = lowp.BELOW[config["compute_dtype"]]
                checks = traffic.calibrate(run, control=lowp.OPS[below])
            elif mode.startswith("fault:"):
                run.extra["fault"] = mode[6:]  # for traffic that plants it in its ranks
                with faults.FAULTS[mode[6:]](cell["traffic"]):
                    checks = traffic.calibrate(run)
            else:
                raise SystemExit(f"unknown mode {mode!r}")
            row = {"workload": workload, "mode": mode, "seed": seed,
                   "seconds": round(time.time() - t0, 3),
                   **{c["name"]: c["value"] for c in checks}}
            if "readings" in run.extra:
                row["worst"] = worst_leaves(*run.extra["readings"])
            rows.append(row)
            print(json.dumps(row), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--modes", nargs="+", default=["program"])
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--out")
    a = p.parse_args(argv)
    readings(a.workload, a.modes, a.seeds, out=a.out)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())

"""Diffusion training with data parallelism over the cards of one host: one
rank a card over nccl (gloo on the CPU), the port's
``parallel/mesh.make_mesh(data=chips)`` and ``make_parallel_train_step``,
the gradients averaged by one ``all_reduce`` after the backward.

``main(run)`` runs in the process the command started: it starts ``chips``
ranks of this file, each a process, waits for them, and makes the result
line from theirs. Parameters as for ``train`` (``batch`` the global batch);
each rank draws the global batch's indices and steps on its rows, so the
ranks together train on the batch one process would.

Each rank times the same window (the first rank decides its end at each
sync, and all end together), traces its own card under ``--trace 1``, and
reports its units, busy time and the device time of its nccl kernels. The
first rank runs the reference once the ranks have left the group: the
same global steps on one card, each rank's rows noised with its folded
seed. ``setup_s`` runs from the first process's start to the window.

    python3 perfbench/traffic/train_dp.py --rank R --world N --port P ...
    (started by ``main``; not meant to be run by hand)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

DEADLINE_S = 330.0  # the ranks' time, within the run's 360 seconds


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(run, mode: str, seeds, fault: str = "") -> list:
    """Start the ranks, wait for all, return each rank's JSON lines (a list
    a rank). A rank that fails or outlives the deadline ends all of them."""
    port, world = _free_port(), run.chips
    dev = "cpu" if run.device.type == "cpu" else "cuda"
    cmd = [sys.executable, str(Path(__file__).resolve()), "--world", str(world), "--port",
           str(port), "--workload", run.cell["name"], "--seconds", str(run.seconds), "--trace",
           str(int(run.traced)), "--root", str(run.root), "--device", dev, "--t0", repr(run.t0),
           "--mode", mode, "--fault", fault, "--seeds", *map(str, seeds)]
    import gan_class_transfer2_tpu_torch as program  # the ranks import the launcher's program

    path = [str(Path(program.__file__).resolve().parents[1]), str(run.root)]
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "4"),
               PYTHONPATH=os.pathsep.join(path + [os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE, text=True,
                              env=env) for r in range(world)]
    deadline = time.time() + DEADLINE_S
    try:
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"data-parallel ranks ended with codes {codes}")
    return [[json.loads(ln) for ln in out.splitlines() if ln.startswith("{")] for out in outs]


class RanksTrace:
    """The readers' view of the ranks' traces: busy time averaged over the
    cards, the first rank's breakdown."""

    def __init__(self, rows):
        self.rows = rows

    def busy_s(self):
        return sum(r["busy_s"] for r in self.rows) / len(self.rows)

    def work_s(self):
        return sum(r["work_s"] for r in self.rows) / len(self.rows)

    def top_ops(self, n=10):
        return self.rows[0]["top_ops"][:n]

    def idle_gaps(self, window_s, n=10):
        return self.rows[0]["idle_gaps"][:n]


def main(run):
    from perfbench.harness import device as dev_lib
    from perfbench.harness import manifest, session

    rows = [r[-1] for r in launch(run, "window", [run.seed])]
    first = rows[0]
    bad = sorted({m for r in rows for m in r["forbidden"]})
    if bad:  # each rank's modules once its window and checks are over
        raise RuntimeError(f"forbidden modules loaded in the ranks: {bad}; no result")
    run.units, run.window_s = first["units"], first["window_s"]
    run.images = first["units"] * run.params["batch"]
    run.setup_s = first["window_start"] - run.t0
    run.extra.update(first["extra"])
    run.extra["nccl_s"] = sum(r["nccl_s"] for r in rows) / len(rows)
    run.memory_peak = max(r["memory_peak"] for r in rows)
    run.checks = first["checks"]
    if run.traced:
        run.tracer = RanksTrace(rows)
    info = dev_lib.info(run.device, run.chips)
    info["memory_peak_bytes"] = run.memory_peak
    if run.traced:
        info["busy_s"] = run.tracer.busy_s()
        info["window_s"] = run.window_s
    return session.result(run, session.read_metrics(run, manifest), info)


def calibrate(run, control=None):
    """As ``train.calibrate``; the program's readings come from the ranks
    (with the fault that ``run.extra["fault"]`` names planted in each)."""
    train = _train(run.root)
    if control is not None:
        pool, order = train.inputs(run)
        raws = [pool.index_select(0, order.next()) for _ in range(run.params["checked_steps"])]
        got = train.reference(run, raws, ops=control, ranks=run.chips)
        ref = train.reference(run, raws, ranks=run.chips)
        run.extra["readings"] = got, ref
        return train.compare_readings(run, got, ref)
    rows = launch(run, "checked", [run.seed], run.extra.get("fault", ""))[0]
    return rows[-1]["checks"]


def calibrate_many(run, seeds, fault: str = "") -> list:
    """The program's checks on each of ``seeds``, the ranks started once."""
    return [row["checks"] for row in launch(run, "checked", seeds, fault)[0]]


def _train(root):
    from perfbench.harness import manifest

    return manifest.traffic(Path(root), "train")


# ------------------------------------------------------------------ a rank


class _Driver:
    """``train.Driver`` on the mesh, with the window's end agreed."""

    def __init__(self, run, mesh, train):
        import torch

        self.inner = train.Driver(run, mesh)
        self.torch, self.dev = torch, mesh.device
        self.images, self.sync_every = self.inner.images, self.inner.sync_every

    def unit(self):
        self.inner.unit()

    def sync(self):
        self.inner.sync()

    def agree(self, done: bool) -> bool:
        flag = self.torch.tensor([1.0 if done else 0.0], device=self.dev)
        self.torch.distributed.broadcast(flag, 0)
        return bool(flag.item())


def _rank_main(a):
    sys.path.insert(0, a.root)
    import torch

    from gan_class_transfer2_tpu_torch.parallel import mesh as mesh_lib
    from gan_class_transfer2_tpu_torch.parallel import multihost

    from perfbench import faults
    from perfbench.harness import manifest, session

    root = Path(a.root)
    bench = manifest.benchmark(root)
    cell = manifest.cell(root, bench, a.workload)
    config = manifest.config(root, bench, cell["config"])
    train = manifest.traffic(root, "train")
    multihost.initialize(f"127.0.0.1:{a.port}", a.world, a.rank, device=a.device)
    mesh = mesh_lib.make_mesh(device=a.device, data=a.world)
    patch = faults.FAULTS[a.fault]("train_dp") if a.fault else contextlib.nullcontext()
    with patch:
        for seed in a.seeds:
            args = SimpleNamespace(seed=seed, seconds=a.seconds, trace=a.trace)
            run = session.Run(args, root, bench, cell, config, mesh.device, a.t0)
            if a.rank:
                run.phase = lambda name: None  # the first rank notes set-up
            out = _rank_run(a, run, mesh, train, session, torch)
            multihost.barrier()
            if a.rank == 0:
                out["checks"] = run.checks_fn()
            multihost.barrier()
            out["forbidden"] = session.loaded_forbidden()  # after the window and the checks
            print(json.dumps(out), flush=True)
    multihost.shutdown()


def _rank_run(a, run, mesh, train, session, torch):
    from perfbench.harness import compare, trace

    drv = _Driver(run, mesh, train)
    out = {"rank": a.rank}
    if a.mode == "window":
        def ready():  # every rank set up before any starts the window
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            torch.distributed.barrier()

        session.window(run, drv, ready)
        drv.inner.count()
        out.update(units=run.units, window_s=run.window_s, window_start=run.t0 + run.setup_s,
                   extra={k: v for k, v in run.extra.items() if k != "calls_per_unit"})
        out["memory_peak"] = (int(torch.cuda.max_memory_allocated(mesh.device))
                              if mesh.device.type == "cuda" else 0)
        tr = run.tracer
        out["busy_s"] = tr.busy_s() if tr else 0.0
        out["work_s"] = tr.work_s() if tr else 0.0
        out["nccl_s"] = tr.kernel_time(trace.COLLECTIVES)[0] if tr else 0.0
        out["top_ops"] = tr.top_ops(10) if tr else []
        out["idle_gaps"] = tr.idle_gaps(run.window_s, 10) if tr else []
    inner = drv.inner
    raws = inner.raws() if a.rank == 0 else None
    readings = inner.readings
    inner.free()
    del drv, inner

    def checks():
        ref = train.reference(run, raws, ranks=a.world)
        return compare.training_checks(readings, ref, run.limits)

    run.checks_fn = checks
    return out


def _parse(argv):
    p = argparse.ArgumentParser()
    for name in ("--rank", "--world", "--port"):
        p.add_argument(name, type=int, required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--root", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--t0", type=float, required=True)
    p.add_argument("--mode", choices=("window", "checked"), default="window")
    p.add_argument("--fault", default="")
    return p.parse_args(argv)


if __name__ == "__main__":
    _rank_main(_parse(sys.argv[1:]))

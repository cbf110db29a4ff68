"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, the readers, and the result line.

A traffic driver (``perfbench/traffic/<kind>.py``) gives ``setup(run)``,
which builds the program's objects from the seed, warms every shape the
cell uses and returns an object with

  * ``unit()``: enqueue one unit of work (a train step, a sampler call);
  * ``sync()``: wait for it (the loss fetch the training loop makes);
  * ``sync_every``: units between syncs; ``images``: images a unit;
  * ``count()``: after the window, the readers' counts (``run.extra``);
  * ``free()``: drop the program's state once the window has closed;
  * ``check()``: the comparisons with the reference, a list of
    ``compare.check`` entries;
  * optionally ``agree(done) -> bool``: over ranks, every rank's decision
    to end the window, made alike (the first rank's).

The window runs units from the first to a sync at or after ``--seconds``:
its rate is all the work and all the time between.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "gan_class_transfer2_tpu")


def process_start() -> float:
    """The ``time.time()`` at which this process started (its start tick in
    /proc/self/stat against the boot time), or now where unreadable."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose (weights, data, draws, noise) from the
    run's ``--seed`` (any whole number) and the purpose's tags."""
    state = np.random.SeedSequence([int(seed) % 2**64, *tags]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What a run knows: its arguments, its cell and configuration, the
    device, and what the window and the readers found."""

    def __init__(self, args, root, bench, cell, config, device, t0):
        self.args, self.root, self.bench, self.cell = args, root, bench, cell
        self.config = config  # the configuration file's fields
        self.params = cell.get("params", {})
        self.limits = cell.get("limits", {})
        self.seed, self.seconds, self.traced = args.seed, args.seconds, bool(args.trace)
        self.device, self.t0 = device, t0
        self.setup_s = self.window_s = None
        self.units = self.images = 0
        self.tracer = None
        self.memory_peak = 0
        self.checks: list = []
        self.extra: dict = {}  # the driver's counts for the readers
        self.chips = cell["chips"]

    def phase(self, name: str) -> None:
        """Note on stderr when a part of set-up ends, seconds from the start."""
        print(f"perfbench: {name} done at {time.time() - self.t0:.3f} s", file=sys.stderr)

    def port_cfg(self, **overrides):
        """The configuration as the program's ``Config``."""
        from gan_class_transfer2_tpu_torch.config import Config

        return Config.from_json(json.dumps({**self.config, **overrides}))

    def ref_cfg(self, **overrides):
        """The configuration as a plain namespace, for the reference."""
        return SimpleNamespace(**{**self.config, **overrides})


@contextlib.contextmanager
def _span(run, name):
    if run.traced:
        import torch

        with torch.profiler.record_function(name):
            yield
    else:
        yield


def _loop(run, driver):
    """Units from the first to a sync at or after ``run.seconds``: (units,
    seconds)."""
    t_start = time.perf_counter()
    units = 0
    while True:
        with _span(run, "perfbench.unit"):
            driver.unit()
        units += 1
        if units % driver.sync_every == 0:
            with _span(run, "perfbench.sync"):
                driver.sync()
            done = time.perf_counter() - t_start >= run.seconds
            if getattr(driver, "agree", None) is not None:
                done = driver.agree(done)
            if done:
                return units, time.perf_counter() - t_start


def window(run, driver, sync):
    """Run ``driver``'s units for ``run.seconds``; ``sync()`` waits for the
    device. A traced run first runs the same window untraced, whose units
    and seconds the utilisation readers take (``run.extra["untraced"]``):
    the profiler's host work slows a host-paced cell by a quarter or more,
    which the traced window's idle share and breakdown show and a rate
    should not."""
    from .trace import Tracer

    sync()
    run.setup_s = time.time() - run.t0
    if run.traced:
        run.extra["untraced"] = _loop(run, driver)
        run.tracer = Tracer()
        run.tracer.start()
    units, run.window_s = _loop(run, driver)
    if run.tracer is not None:
        run.tracer.stop()
    run.units, run.images = units, units * driver.images


def run_single(run, traffic):
    """The one-process flow: set-up, window, peak memory, then the program
    freed and the reference's comparison."""
    import torch

    driver = traffic.setup(run)
    dev = run.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    window(run, driver, sync)
    if dev.type == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated(dev))
    driver.count()
    checks_fn = driver.check
    driver.free()
    del driver
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.checks = checks_fn()


def read_metrics(run, manifest) -> dict:
    out = {}
    for entry in manifest.cell_metrics(run.bench, run.cell["name"], run.traced):
        value = manifest.metric(run.root, entry["name"]).read(run)
        if value is not None and math.isfinite(value):
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def result(run, metrics: dict, device: dict) -> dict:
    correct = bool(run.checks) and all(c["ok"] for c in run.checks)
    line = {
        "correct": correct,
        "attempted": run.units,
        "failed": sum(not c["ok"] for c in run.checks),
        "metrics": metrics,
        "device": device,
    }
    if run.tracer is not None:
        line["breakdown"] = {"device_ops": run.tracer.top_ops(10),
                             "idle_gaps": run.tracer.idle_gaps(run.window_s, 10)}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in run.checks}
    return line


def emit(line: dict) -> int:
    """Print the comparisons on stderr, then the result on stdout, unless a
    forbidden module is loaded: then no result and a non-zero exit."""
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: forbidden modules loaded in this process: {bad}; no result",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

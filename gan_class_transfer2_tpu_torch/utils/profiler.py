"""Profiling hooks — counterpart of gan_class_transfer2_tpu/utils/profiler.py.

  * ``trace(log_dir)`` — a ``torch.profiler`` capture of the enclosed block
    (host ops, and CUDA kernels when a card is present); on exit the trace
    is written to ``log_dir/trace.json`` (Chrome/Perfetto format);
  * ``device_ops(prof, top)`` — the capture's CUDA kernels by self time,
    ``{"ms", "calls", "op"}`` rows sorted by time, the top N (the JAX
    parser's rows, read from the profiler instead of an xplane file);
  * ``StepTimer`` — wall-clock step times, each lap ending in a
    synchronising fetch of a value the step produced.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Yields the running ``torch.profiler.profile``; read it after the
    block (``device_ops``)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _kernels(prof):
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]


def device_busy_ms(prof) -> float:
    """Sum of the CUDA kernels' self time in the capture, ms (0 without a
    card). Kernels on one stream do not overlap, so this is the time the
    device was busy."""
    return sum(e.self_device_time_total for e in _kernels(prof)) / 1e3


def device_ops(prof, top: Optional[int] = 25) -> list:
    """Up to ``top`` rows (every row for None) ``{"ms", "calls", "op"}``:
    CUDA kernel self time summed over the capture, by kernel name, largest
    first."""
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in _kernels(prof)),
                  reverse=True)
    return [{"ms": ms, "calls": n, "op": name[:120]} for ms, n, name in rows[:top]]


class StepTimer:
    """Wall-clock per-step timing; ``lap`` fetches a value of the step
    (``float(loss)``), which waits for the device."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def lap(self, sync_value) -> float:
        if self._t0 is None:  # fail before the device fetch
            raise RuntimeError("StepTimer.lap() called before start()")
        float(sync_value)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self._t0 = time.perf_counter()
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        p90 = ts[max(0, math.ceil(0.9 * n) - 1)]  # nearest rank
        return {
            "steps": n,
            "mean_ms": sum(ts) / n * 1000,
            "p50_ms": ts[n // 2] * 1000,
            "p90_ms": p90 * 1000,
            "min_ms": ts[0] * 1000,
        }

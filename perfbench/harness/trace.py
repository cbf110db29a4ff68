"""The traced window: ``torch.profiler`` over host and device, read from its
raw events (not ``key_averages``, which builds an object a row and takes
minutes over a busy window).

  * device operations: the kernels, copies and fills on the card, each an
    interval on its device's clock (a range that ``record_function`` marks
    shows on the card too, and is not an operation: ``split``);
  * busy: the union of those intervals, so that operations overlapping on
    two streams (a collective beside a kernel) count once; ``work_s`` is
    the same without the collectives;
  * idle gaps: each stretch between busy intervals, named by the innermost
    host event (operator, marked range or runtime call) running at its
    middle: what the host was doing while the card waited;
  * ``kernel_time(pattern)``: the summed device time and count of the
    operations whose name matches, for the roofline readers.
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np
import torch

COLLECTIVES = r"nccl"  # the device operations of collectives, by name


def split(events):
    """(device operations, host events) of the profiler's raw events, each a
    list of (start_ns, end_ns, name). Every event on the card is an
    operation but a marked range: ``record_function`` projects its host
    range onto the card under the same name, flagged as a user annotation
    or not, and the range is neither an operation nor busy time."""
    cuda = torch.autograd.DeviceType.CUDA
    ranges = {e.name() for e in events if e.device_type() != cuda and e.is_user_annotation()}
    device, host = [], []
    for e in events:
        row = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() != cuda:
            host.append(row)
        elif not (e.is_user_annotation() or e.name() in ranges):
            device.append(row)
    return device, host


class Tracer:
    """``start()`` before the window, ``stop()`` after its last sync."""

    def __init__(self):
        self._prof = None
        self.device_ops: list = []  # (start_ns, end_ns, name)
        self.host_ops: list = []  # (start_ns, end_ns, name)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self):
        self._prof.stop()
        self.device_ops, self.host_ops = split(self._prof.profiler.kineto_results.events())
        self._prof = None
        self.device_ops.sort()

    # ------------------------------------------------------------ readings

    def busy_intervals(self, exclude: str = None):
        """The union of the device operations' intervals, without those whose
        name matches the regular expression ``exclude``."""
        rx = re.compile(exclude) if exclude else None
        merged = []
        for s, e, name in self.device_ops:
            if rx is not None and rx.search(name):
                continue
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        return merged

    def busy_s(self, exclude: str = None) -> float:
        return sum(e - s for s, e in self.busy_intervals(exclude)) / 1e9

    def work_s(self) -> float:
        """Busy time without the collectives: a collective's kernel runs on
        while it waits for the slowest rank, and waits longer the more the
        profiler's host work sets the ranks apart."""
        return self.busy_s(exclude=COLLECTIVES)

    def kernel_time(self, pattern: str):
        """(seconds, count) of the device operations whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [(e - s) for s, e, name in self.device_ops if rx.search(name)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, n=10):
        by = defaultdict(int)
        for s, e, name in self.device_ops:
            by[name[:160]] += e - s
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, window_s: float, n=10):
        """The idle time by what the host did: ``[[name, seconds]]``, the
        largest sums first. Gaps between device operations are named by the
        innermost host event at their middle (none: the interpreter between
        traced calls); what the window holds beyond the first and last
        operation is ``window edges``."""
        busy = self.busy_intervals()
        if not busy:
            return []
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        by = defaultdict(float)
        span = (busy[-1][1] - busy[0][0]) / 1e9
        edge = window_s - span
        if edge > 0:
            by["window edges"] += edge
        if gaps and self.host_ops:
            hs = np.array([h[0] for h in self.host_ops], dtype=np.int64)
            he = np.array([h[1] for h in self.host_ops], dtype=np.int64)
            order = np.argsort(hs)
            hs, he = hs[order], he[order]
            names = [self.host_ops[i][2] for i in order]
            g = np.array(gaps, dtype=np.int64)
            mids = (g[:, 0] + g[:, 1]) // 2
            lengths = (g[:, 1] - g[:, 0]) / 1e9
            # the innermost host event covering each middle: the latest start
            # at or before it whose end is after it (checked over a few
            # candidates back from the latest start)
            idx = np.searchsorted(hs, mids, side="right") - 1
            for mid, k, length in zip(mids, idx, lengths):
                name = "host: Python between traced calls"
                for j in range(k, max(k - 64, -1), -1):
                    if he[j] >= mid:
                        name = names[j]
                        break
                by[name[:160]] += float(length)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

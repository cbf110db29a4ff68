"""Profiling hooks — counterpart of gan_class_transfer2_tpu/utils/profiler.py.

  * ``trace(log_dir)`` — a ``torch.profiler`` capture of the enclosed block
    (host ops, and CUDA kernels when a card is present); on exit the trace
    is written to ``log_dir/trace.json`` (Chrome/Perfetto format);
  * ``device_ops(prof, top)`` — the capture's CUDA kernels by self time,
    ``{"ms", "calls", "op"}`` rows sorted by time, the top N (the JAX
    parser's rows, read from the profiler instead of an xplane file);
  * ``device_busy_ms(prof)`` — the union of the capture's device
    operations' intervals;
  * ``StepTimer`` — wall-clock step times, each lap ending in a
    synchronising fetch of a value the step produced;
  * ``annotate(name)`` — the port's span, JAX's ``TraceAnnotation``: while
    a capture runs, a named range in it (``torch.profiler.record_function``)
    and a record of its own (``spans``, ``span_table``, ``reset``,
    ``dropped``); otherwise one flag read;
  * ``count(name, n)`` — a host counter of the program's own (``counters``),
    always on, with no device sync: ``image_pool.queries`` and
    ``image_pool.images`` (train/image_pool.py);
  * ``compiled_stats(fn, *args)`` — the FLOPs of a call without running it
    on real data, with JAX's keys (``flops``, ``bytes_accessed``,
    ``memory_mb``).
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _capture  # ``_is_profiler_enabled``: a capture runs


@contextlib.contextmanager
def trace(log_dir: str):
    """Yields the running ``torch.profiler.profile``; read it after the
    block (``device_ops``, ``spans``). The span records are reset on entry,
    so they hold the block's own."""
    from torch.profiler import ProfilerActivity, profile

    reset()
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


# ----------------------------------------------------------------- spans

SPAN_CAP = 1 << 16  # records kept between resets; the rest are counted as dropped
_OFF = contextlib.nullcontext()  # the span of every call while no capture runs


class _Log:
    """The closed spans' records, the count of those past ``SPAN_CAP``, the
    step counter, each thread's open spans and those of the thread that
    opened the newest step, and the CUDA event pairs free for reuse."""

    def __init__(self):
        self.lock = threading.Lock()
        self.open = threading.local()
        self.step_stack: list = []
        self.free: dict = {}  # by card: event pairs of records read, reset or dropped
        self.records: list = []
        self.reset()

    def reset(self):
        with self.lock:
            for r in self.records:
                self.give(r)
            self.records, self.dropped, self.steps = [], 0, 0
            self.counts = {}

    def stack(self) -> list:
        stack = getattr(self.open, "stack", None)
        if stack is None:
            stack = self.open.stack = []
        return stack

    def add(self, span):
        with self.lock:
            if len(self.records) < SPAN_CAP:
                self.records.append(span)
            else:
                self.dropped += 1
                self.give(span)

    def give(self, span):
        """Keep ``span``'s events for a later span on its card; the lock held."""
        if span.events is not None:
            self.free.setdefault(span.stream.device_index, []).append(span.events)
            span.events = None


_log = _Log()


def _event_pair(device: int):
    try:
        return _log.free[device].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class _Span:
    """A span while a capture runs, and its record: a ``record_function``
    range, host ``time.time_ns()`` stamps (the capture's clock) just inside
    it, and a pair of CUDA events on the current stream once CUDA is in
    use (reused from records already read, where there are any)."""

    __slots__ = ("name", "is_step", "parent", "step", "thread", "start_ns", "end_ns", "events",
                 "stream", "device_ms", "range")

    def __init__(self, name, is_step):
        self.name, self.is_step = name, is_step
        self.events = self.device_ms = None

    def __enter__(self):
        stack = _log.stack()
        if self.is_step:
            with _log.lock:
                _log.steps += 1
            _log.step_stack = stack
        # With no span open on its own thread (autograd's device thread), a
        # span is the child of the innermost one open on the step's thread.
        top = stack[-1:] or _log.step_stack[-1:]
        self.parent = top[0] if top else None
        self.step, self.thread = _log.steps, threading.get_ident()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            self.stream = torch.cuda.current_stream()
            self.events = _event_pair(self.stream.device_index)
            self.events[0].record(self.stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _log.stack().pop()
        if self.events is not None:
            self.events[1].record(self.stream)
        self.end_ns = time.time_ns()
        self.range.__exit__(*exc)
        self.range = None
        _log.add(self)
        return False


def annotate(name: str, step: bool = False):
    """The port's span around the enclosed region. While no ``torch.profiler``
    capture runs (``trace`` or any other), it is one shared context that does
    nothing. While one runs, it is a ``record_function`` range in the capture
    (a host range, with the CUDA kernels it launches under it) and a record
    for ``spans``: its name, its parent, its step, host start and end, and
    its extent on its stream. ``step``: a top-level step span, which numbers
    the steps; the spans opened under it, on any thread, carry its number.
    The parent is the innermost span open on the same thread, or, for a
    span opened on a thread with none open (autograd's device thread, which
    runs the backward on a card), the innermost open on the thread of the
    newest step: so a span nests alike on the CPU and on a card. A span
    opened outside any step (``train.augment`` from ``distill`` or the
    pipeline) has no parent and carries the number of the last step."""
    if not _capture._is_profiler_enabled:
        return _OFF
    return _Span(name, step)


def reset() -> None:
    """Drop the span records, the count of dropped ones, the step count and
    the counters."""
    _log.reset()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host int: nothing waits for the card) to the counter
    ``name``, whether or not a capture runs."""
    with _log.lock:
        _log.counts[name] = _log.counts.get(name, 0) + n


def counters() -> dict:
    """``{name: total}`` of every counter since the last ``reset`` (which
    ``trace`` makes on entry)."""
    with _log.lock:
        return dict(_log.counts)


def dropped() -> int:
    """Spans closed past ``SPAN_CAP`` since the last reset, not recorded:
    where above 0, ``spans()`` lacks some and its sums a step read low."""
    return _log.dropped


def spans() -> list:
    """The closed spans' records by start: ``{"name", "parent" (the index of
    the enclosing span in this list, or None), "step", "thread", "start_ns",
    "end_ns" (``time.time_ns()``), "device_ms"}``. ``device_ms`` is the
    span's extent on its stream, from the card reaching its start to the
    card reaching its end (waits for the host inside it included); None off
    the card. The caller synchronises the card first; the events read are
    kept for later spans."""
    with _log.lock:
        recs = sorted(_log.records, key=lambda r: r.start_ns)
        for r in recs:
            if r.events is not None:
                r.device_ms = r.events[0].elapsed_time(r.events[1])
                _log.give(r)
    index = {id(r): i for i, r in enumerate(recs)}
    return [{"name": r.name, "parent": index.get(id(r.parent)),
             "step": r.step, "thread": r.thread, "start_ns": r.start_ns, "end_ns": r.end_ns,
             "device_ms": r.device_ms}
            for r in recs]


def span_table(records: list, steps: int) -> list:
    """One row a span name of ``records`` (``spans()``), in order of first
    start: ``calls_per_step``, ``host_ms_per_step``, ``self_host_ms_per_step``
    (the duration less its child spans', those on autograd's thread
    included), ``device_ms_per_step`` (None off the card)."""
    children = [0] * len(records)
    for r in records:
        if r["parent"] is not None:
            children[r["parent"]] += r["end_ns"] - r["start_ns"]
    rows: dict = {}
    for r, child_ns in zip(records, children):
        row = rows.setdefault(r["name"], [0, 0, 0, 0.0])
        host = r["end_ns"] - r["start_ns"]
        row[0] += 1
        row[1] += host
        row[2] += host - child_ns
        row[3] = None if row[3] is None or r["device_ms"] is None else row[3] + r["device_ms"]
    return [{"span": name, "calls_per_step": n / steps, "host_ms_per_step": host / 1e6 / steps,
             "self_host_ms_per_step": own / 1e6 / steps,
             "device_ms_per_step": None if dev is None else dev / steps}
            for name, (n, host, own, dev) in rows.items()]


def compiled_stats(fn, *args) -> dict:
    """The cost of ``fn(*args)`` without running it on real data: ``fn`` runs
    once on fake tensors of the arguments' shapes, dtypes and devices
    (``FakeTensorMode``; parameters it closes over are taken in as fakes),
    under ``torch.utils.flop_counter.FlopCounterMode``.

    ``flops``: the counter's total: 2 per multiply-add of the matrix
    products and convolutions, forward and any backward ``fn`` takes
    (B4's custom op ``gct2::down_conv_k4s2`` included); elementwise work is
    not counted, where XLA's cost analysis counts it. ``bytes_accessed``
    and ``memory_mb`` are always None: eager PyTorch has no compiled
    program whose traffic or temporary buffers could be read before it
    runs (JAX gives None where a backend lacks them, too)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with FlopCounterMode(display=False) as counter:
            fn(*fake)
    return {"flops": counter.get_total_flops(), "bytes_accessed": None, "memory_mb": None}


def _kernels(prof):
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]


def union_ns(intervals) -> int:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def device_busy_ms(prof) -> float:
    """The union of the intervals of the capture's device operations, ms (0
    without a card): operations overlapping on two streams count once. A
    ``record_function`` range's projection onto the card is not an
    operation (as ``perfbench/harness/trace.split`` reads the events)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    ranges = {e.name() for e in events if e.device_type() != cuda and e.is_user_annotation()}
    return union_ns((e.start_ns(), e.end_ns()) for e in events if e.device_type() == cuda
                    and not (e.is_user_annotation() or e.name() in ranges)) / 1e6


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

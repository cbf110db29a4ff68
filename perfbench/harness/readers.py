"""What the metric files share. A reader returns None where it finds
nothing to read; it never returns 0 for a share of a peak or a roofline."""

from __future__ import annotations

from . import counts
from . import device as device_lib


def rate(run):
    """Images a second over the window."""
    return run.images / run.window_s if run.window_s else None


def mfu(run):
    """% of the cards' dense peak in the configuration's compute dtype that
    the reference's model FLOPs of the window's units take over its wall
    time: the untraced window's, which a traced run runs first."""
    flops = run.extra.get("flops_per_unit")
    units, seconds = run.extra.get("untraced", (run.units, run.window_s))
    kind = _kind(run)
    peak = device_lib.peak(kind, "flops", run.config["compute_dtype"]) if kind else None
    if not flops or not peak or not seconds:
        return None
    return 100.0 * flops * units / seconds / (run.chips * peak)


def idle(run):
    """% of the untraced window in which no operation but a collective ran on
    the card: the traced window's device busy time a unit, collectives left
    out (``Tracer.work_s``), times the untraced window's units a second.
    The profiler's host work slows a host-paced window and so lengthens its
    gaps, not the operations; a collective, though, spins while it waits
    for the slowest rank, which the profiler sets further apart. The traced
    window's own share, every operation in, is ``device.busy_s`` over
    ``device.window_s`` in the result line. Where the card never waits it
    reads 0 to within the profiler's own lengthening of the operations, a
    few tenths of a point, below 0 as well as above."""
    if run.tracer is None or not run.units:
        return None
    busy = run.tracer.work_s()
    units, seconds = run.extra.get("untraced", (run.units, run.window_s))
    if busy <= 0 or not seconds:
        return None
    return 100.0 * (1.0 - busy / run.units * units / seconds)


def roofline(run, kernels: str, calls: list, count, launch_pattern: str = None,
             peak_dtype: str = None):
    """% of the device time of the operations named by ``kernels`` (a regular
    expression) that the least time of their work takes: ``calls`` are one
    unit's calls the kernel serves, each ``count(call) -> (ops, bytes)``.
    The launches that ``launch_pattern`` names (``kernels`` by default) must
    number one a call over the traced units; otherwise the work cannot be
    matched to the time, and the reader returns None. ``peak_dtype``: the
    dtype whose peak the operations are held to (the configuration's by
    default; float32 for elementwise kernels that compute in it)."""
    kind = _kind(run)
    if run.tracer is None or not calls or kind is None:
        return None
    seconds, _ = run.tracer.kernel_time(kernels)
    _, launches = run.tracer.kernel_time(launch_pattern or kernels)
    if seconds <= 0 or launches != len(calls) * run.units:
        return None
    fpeak = device_lib.peak(kind, "flops", peak_dtype or run.config["compute_dtype"])
    bpeak = device_lib.peak(kind, "bytes_per_s")
    least = sum(counts.least_seconds(*count(c), fpeak, bpeak) for c in calls) * run.units
    return 100.0 * least / seconds


def _kind(run):
    if run.device.type != "cuda":
        return None
    import torch

    return torch.cuda.get_device_name(run.device)

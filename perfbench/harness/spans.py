"""What the span readers share: the program's own span records
(``gan_class_transfer2_tpu_torch/utils/profiler.spans``), which it keeps
while a ``torch.profiler`` capture runs: here, the traced window alone.

A span's device time is its extent on its stream, from the card reaching
the span's start to the card reaching its end, read from the pair of CUDA
events the span records. Where the host falls behind inside a span, the
extent includes the card's wait for it."""

from __future__ import annotations


def per_unit_ms(run, name: str, step: str):
    """The device ms of the spans named ``name`` summed over the traced
    window, a unit. None where there is nothing to read: no traced window,
    a program without span records, spans dropped past the program's cap
    (the sum would read low), top-level ``step`` spans that do not number
    the window's units, or a span without device time (off the card, where
    no CUDA events are recorded)."""
    if run.tracer is None or not run.units:
        return None
    try:
        from gan_class_transfer2_tpu_torch.utils import profiler

        read, dropped = profiler.spans, profiler.dropped
    except (ImportError, AttributeError):
        return None
    if dropped():
        return None
    if run.device.type == "cuda":
        import torch

        torch.cuda.synchronize(run.device)
    records = read()
    if sum(r["name"] == step and r["parent"] is None for r in records) != run.units:
        return None
    ms = [r["device_ms"] for r in records if r["name"] == name]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / run.units

"""The numbers that decide ``correct``: gaps between what the program did
and what the plain reference did, each held to a limit of the cell's."""

from __future__ import annotations

import math
import statistics


def rel_gap(value, ref) -> float:
    return abs(value - ref) / max(abs(ref), 1e-30)


def loss_gap(losses, ref_losses) -> float:
    """The largest relative gap over the steps compared."""
    if len(losses) != len(ref_losses):
        return math.inf
    return max(rel_gap(a, b) for a, b in zip(losses, ref_losses))


def leaf_gaps(norms: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap, as ``worst_leaf`` takes them."""
    median = statistics.median(ref[k] for k in ref)
    return {k: abs(norms.get(k, math.inf) - ref[k]) / max(ref[k], median, 1e-30)
            for k in ref if keep is None or k in keep}


def worst_leaf(norms: dict, ref: dict, keep=None) -> float:
    """max over leaves of |‖program leaf‖ − ‖reference leaf‖| / max(‖reference
    leaf‖, median reference leaf): the gap of the norms, not the norm of the
    difference. ``keep``: the leaves compared (all by default). A leaf the
    program lacks reads as infinitely far."""
    names = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in names:
        if k not in norms or not math.isfinite(norms[k]):
            return math.inf
        worst = max(worst, abs(norms[k] - ref[k]) / max(ref[k], median, 1e-30))
    return worst


def moved_leaves(ref_grad_norms: dict, floor: float = 1e-3) -> set:
    """Leaves whose reference gradient is at least ``floor`` of the median
    leaf's. The others' gradient is nought up to rounding (a conv's bias
    ahead of an instance norm, whose mean the norm takes out), so their
    gradient and change are round-off on both sides."""
    median = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= floor * median}


FP32_SPACING = 2.0**-23  # float32's spacing relative to a value


def resolved_leaves(ref, steps: float = 100.0) -> set:
    """Leaves whose reference change spans at least ``steps`` float32
    spacings of the leaf's root-mean-square value: ‖Δ‖ / (rms(v)·2⁻²³).
    Under a warm-up's first learning rates (about 1e-8) a leaf of values
    near 1, such as a norm's scale, moves by less than one spacing an
    element, so whether it moves at all is rounding, on either side."""
    out = set()
    for k, d in ref.delta_norms.items():
        rms = ref.value_norms[k] / math.sqrt(ref.numel[k])
        if rms == 0 or d / (rms * FP32_SPACING) >= steps:
            out.add(k)
    return out


def training_checks(got, ref, limits: dict, losses=None, ref_losses=None) -> list:
    """A training cell's numbers: the loss gap over the checked steps, the
    worst moved leaf's first-gradient gap, the worst moved and resolved
    leaf's change gap; each only where the cell gives it a limit."""
    moved = moved_leaves(ref.grad_norms)
    values = {
        "loss_gap": lambda: loss_gap(got.losses if losses is None else losses,
                                     ref.losses if ref_losses is None else ref_losses),
        "grad_gap": lambda: worst_leaf(got.grad_norms, ref.grad_norms, moved),
        "delta_gap": lambda: worst_leaf(got.delta_norms, ref.delta_norms,
                                        moved & resolved_leaves(ref)),
    }
    return [check(name, fn(), limits[name]) for name, fn in values.items() if name in limits]


def check(name, value, limit) -> dict:
    value = float(value)
    return {"name": name, "value": value, "limit": float(limit),
            "ok": math.isfinite(value) and value <= limit}

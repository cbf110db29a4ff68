"""The card: the check that it is there, its name and power limit, and the
table of peaks the utilisation and roofline readers divide by.

Peaks are NVIDIA's data-sheet numbers for the H100 SXM (dense, no
sparsity, at its 700 W limit): a card under a lower limit runs slower, so
every result carries the limit beside the name.
"""

from __future__ import annotations

import subprocess
import sys

import torch

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "flops": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12, "tf32": 495e12},
        "bytes_per_s": 3.35e12,
    },
}


def require_cards(n: int) -> None:
    """Exit non-zero, before any result, without ``n`` cards."""
    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False; no result", file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < n:
        print(f"perfbench: the cell needs {n} cards, torch sees "
              f"{torch.cuda.device_count()}; no result", file=sys.stderr)
        raise SystemExit(3)


def power_limit() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def info(device, count: int) -> dict:
    """The result's ``device`` object, less the peak and the trace's times."""
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}
    return {"platform": "cpu", "kind": "cpu", "count": count}


def peak(kind: str, what: str, dtype: str = None):
    """A peak of the card named ``kind``: ``what`` is ``flops`` (of
    ``dtype``) or ``bytes_per_s``. None for a card the table lacks."""
    entry = PEAKS.get(kind)
    if entry is None:
        return None
    return entry["flops"].get(dtype) if what == "flops" else entry[what]

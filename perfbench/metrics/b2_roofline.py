"""b2_roofline: the fused Adam kernel B2 (``ops/adam_kernel.py``,
``csrc/adam.cu``; device operations named ``adam_kernel``) against its least
time: each step's one update of every float32 parameter, moments float32,
7 × 4 bytes a parameter at the card's bandwidth, over B2's device time in
the traced window, %. One launch a step (the denoiser's leaves fit one)."""

from perfbench.harness import counts, readers

KERNELS = r"\badam_kernel\b"


def read(run):
    numel = run.extra.get("param_numel")
    if not numel:
        return None
    return readers.roofline(run, KERNELS, [numel], counts.adam, peak_dtype="float32")

"""b3_roofline: the single-launch instance norm B3 (``ops/norm.py``,
``csrc/instance_norm.cu``; device operations named ``instance_norm_kernel``)
against its least time: every norm of a G/D step (the reference's forwards
record their shapes, 102 at the cycle GAN's defaults), x read and y written
once in the compute dtype, over B3's device time in the traced window, %."""

from perfbench.harness import counts, readers

KERNELS = r"\binstance_norm_kernel\b"


def read(run):
    dtype = run.config["compute_dtype"]
    calls = [c for c in run.extra.get("calls_per_unit", []) if c[0] == "instance_norm"]
    return readers.roofline(run, KERNELS, calls, lambda c: counts.instance_norm(c[1], dtype),
                            peak_dtype="float32")

"""bwd_ms.train: the diffusion step's backward (the program's span
``train.backward``, its ``torch.autograd.grad`` call), device ms a step in
the traced window: the span's extent on its stream, which includes any
wait for the host inside it."""

from perfbench.harness import spans


def read(run):
    return spans.per_unit_ms(run, "train.backward", "train.step")

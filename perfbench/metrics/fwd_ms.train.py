"""fwd_ms.train: the diffusion step's forward (the program's span
``train.forward``: t and ε drawn, B1's noising, the denoiser's forward and
the loss), device ms a step in the traced window: the span's extent on its
stream, which includes any wait for the host inside it."""

from perfbench.harness import spans


def read(run):
    return spans.per_unit_ms(run, "train.forward", "train.step")

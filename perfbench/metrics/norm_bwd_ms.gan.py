"""norm_bwd_ms.gan: B3's backward in the cycle-GAN step (the program's span
``norm.backward`` around ``ops/norm._in_bwd``, torch ops, on autograd's
device thread), device ms of all of a step's spans summed, a step of the
traced window. Each span's extent on its stream includes any wait for the
host inside it."""

from perfbench.harness import spans


def read(run):
    return spans.per_unit_ms(run, "norm.backward", "gan.step")

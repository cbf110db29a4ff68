"""trunk_fwd_ms.cyclegan: the ResNet generator's residual trunk in the
published CycleGAN's step (the program's span ``resnet.trunk`` around the
nine blocks of each generator forward, six a step), device ms of all of a
step's spans summed, a step of the traced window. None for a program without
the span."""

from perfbench.harness import spans


def read(run):
    return spans.per_unit_ms(run, "resnet.trunk", "gan.step")

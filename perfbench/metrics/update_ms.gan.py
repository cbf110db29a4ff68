"""update_ms.gan: the cycle-GAN step's update (the program's span
``gan.update``: G's and D's optax-form Adam, leaf by leaf, and the two
EMAs), device ms a step in the traced window. The span's extent on its
stream includes the card's waits for the host inside it: in this
host-paced phase, that wait is what a faster update would remove."""

from perfbench.harness import spans


def read(run):
    return spans.per_unit_ms(run, "gan.update", "gan.step")

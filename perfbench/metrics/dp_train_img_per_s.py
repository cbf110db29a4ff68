"""dp_train_img_per_s: diffusion-training images taken from the data over the
window's wall time under data parallelism, every card's images counted, host
clock. The same quantity as ``train_img_per_s``, with a bound of its own: the
ranks' hosts pace the step, so its runs spread wider than one card's."""

from perfbench.harness import readers


def read(run):
    return readers.rate(run)

"""train_img_per_s: diffusion-training images taken from the data over the
window's wall time on one card, host clock."""

from perfbench.harness import readers


def read(run):
    return readers.rate(run)

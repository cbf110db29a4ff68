"""gan_img_per_s: cycle-GAN training images taken from the data (both
classes') over the window's wall time, host clock."""

from perfbench.harness import readers


def read(run):
    return readers.rate(run)

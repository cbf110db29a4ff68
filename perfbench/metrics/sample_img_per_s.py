"""sample_img_per_s: images finished by whole sampler calls over the
window's wall time, start of the first call to end of the last (host
clock)."""

from perfbench.harness import readers


def read(run):
    return readers.rate(run)

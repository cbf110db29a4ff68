"""sample_mfu: the sampler's model FLOPs (``steps`` forwards of the plain
reference's denoiser a call, counted on shape-only tensors) over the untraced
window's wall time and the card's dense peak in the compute dtype, %."""

from perfbench.harness import readers


def read(run):
    return readers.mfu(run)

"""gan_mfu: the G/D step's model FLOPs (counted from the plain reference on
shape-only tensors: six generator and six discriminator passes and both
backwards, no recomputation) over the untraced window's wall time and the
card's dense peak in the compute dtype, %."""

from perfbench.harness import readers


def read(run):
    return readers.mfu(run)

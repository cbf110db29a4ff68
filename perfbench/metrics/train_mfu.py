"""train_mfu: the diffusion train step's model FLOPs (counted from the
plain reference on shape-only tensors, forward and backward, no
recomputation) over the untraced window's wall time and the cards' dense
peak in the compute dtype, %."""

from perfbench.harness import readers


def read(run):
    return readers.mfu(run)

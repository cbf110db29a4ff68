"""dp_train_mfu: the data-parallel diffusion train step's model FLOPs over
every card (counted from the plain reference on shape-only tensors, forward
and backward, no recomputation) over the untraced window's wall time and the
cards' dense peak in the compute dtype, %."""

from perfbench.harness import readers


def read(run):
    return readers.mfu(run)

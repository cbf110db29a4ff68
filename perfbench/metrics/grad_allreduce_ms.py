"""grad_allreduce_ms: the device time of the nccl kernels a train step, from
each rank's trace, averaged over the ranks: the flat gradient all-reduce
after the backward (and the window's one-flag broadcast at each sync), ms."""


def read(run):
    nccl = run.extra.get("nccl_s")
    if not nccl or not run.units:
        return None
    return 1e3 * nccl / run.units

"""device_idle.sample: % of the untraced sampling window in which no operation
but a collective ran on the card: 1 − (device busy time a unit in the traced
window, collectives left out) × (units a second untraced)."""

from perfbench.harness import readers


def read(run):
    return readers.idle(run)

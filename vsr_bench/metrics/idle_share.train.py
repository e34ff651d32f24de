"""Share of the traced training window in which the device ran nothing, %."""

from vsr_bench import readers


def read(t):
    return readers.idle_share(t)

"""Device busy time (the union of kernels and copies) a live frame, ms."""

from vsr_bench import readers


def read(t):
    return readers.busy_ms(t)

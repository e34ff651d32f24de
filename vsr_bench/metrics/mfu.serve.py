"""The whole forward's share of the H100's bf16 peak, %."""

from vsr_bench import readers


def read(t):
    return readers.mfu(t)

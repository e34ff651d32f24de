"""The whole train step's share of the H100's bf16 peak, %: the
reference's forward and backward operations a step."""

from vsr_bench import readers


def read(t):
    return readers.mfu(t)

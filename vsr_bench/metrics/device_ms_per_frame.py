"""Device time a served frame, ms: the union of the device's kernels and
copies over the measured window (the untraced run records the device's
activity alone), over the HR frames delivered in it. What the card spends
on a frame, apart from the time it waits for the host."""

from vsr_bench import readers


def read(t):
    return readers.busy_ms(t)

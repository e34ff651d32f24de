"""The convolutions' share of their roofline, %: the least time of every
3x3 conv of the reference's forward at the cell's shapes (the frozen
``conv3x3_roofline_ms`` against the datasheet peak, at the configured
compute type, f32 where the model computes in f32) over the device time of
the trace's convolution kernels (``readers.CONV_KERNEL``: the port's and
any library's), a served frame each."""

from vsr_bench import readers


def read(t):
    return readers.conv_roofline(t)

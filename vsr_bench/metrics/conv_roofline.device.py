"""``conv_roofline.serve``'s reading, for the cells that report
``device_ms_per_frame``: the convolutions' share of their roofline, %."""

from vsr_bench import readers


def read(t):
    return readers.conv_roofline(t)

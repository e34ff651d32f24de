"""The convolutions' share of their roofline in whole-clip serving, %:
the least time of every conv the reference records a frame, at its kernel
size (SPyNet's 7x7, the trunks' and the upsampler's 3x3, the 1x1 fusion),
over the device time of the port's and the library's conv kernels a
frame."""

from vsr_bench import readers


def read(t):
    return readers.conv_roofline(t)

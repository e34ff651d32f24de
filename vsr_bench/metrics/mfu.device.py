"""The whole forward's share of the H100's bf16 peak while the device is
busy, %: the reference's operations a frame over ``device_ms_per_frame``'s
device time a frame."""

from vsr_bench import readers


def read(t):
    return readers.mfu_busy(t)

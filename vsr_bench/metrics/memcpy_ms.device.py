"""``memcpy_ms.serve``'s reading, for the cells that report
``device_ms_per_frame``: device time of the host-to-device and
device-to-host copies, ms a served frame."""

from vsr_bench import readers


def read(t):
    return readers.memcpy_ms(t)

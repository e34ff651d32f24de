"""Device time of the host-to-device and device-to-host copies in
whole-clip serving (the clip's one upload, each HR frame's copy back), ms
a served frame."""

from vsr_bench import readers


def read(t):
    return readers.memcpy_ms(t)

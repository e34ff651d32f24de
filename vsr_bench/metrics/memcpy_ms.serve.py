"""Device time of the host-to-device and device-to-host copies (the LR
windows' uploads, the HR frames' copies back), ms a served frame."""

from vsr_bench import readers


def read(t):
    return readers.memcpy_ms(t)

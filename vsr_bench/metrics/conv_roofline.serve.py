"""The convolutions' share of their roofline, %: the least time of every
3x3 conv of the reference's forward at the cell's shapes (the frozen
``conv3x3_roofline_ms`` against the datasheet peak, at the configured
compute type, f32 where the model computes in f32) over the device time of
the trace's convolution kernels (``readers.CONV_KERNEL``: the port's and
any library's), a served frame each."""

from vsr_bench import readers


def read(t):
    if not t.on_card or not t.units:
        return None
    us = sum(e.dur for e in t.events if readers.CONV_KERNEL.search(e.name))
    if us <= 0:
        return None
    return 100.0 * t.work()["conv_floor_ms"] * t.units / (us / 1e3)

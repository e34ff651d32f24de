"""``stage_ms.warp.serve``'s reading, for the cells that report
``device_ms_per_frame``: device time under the ``warp`` range, ms a served
frame."""

from vsr_bench import readers


def read(t):
    return readers.span_ms(t, ("warp",))

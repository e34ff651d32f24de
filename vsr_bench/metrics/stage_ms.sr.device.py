"""``stage_ms.sr.serve``'s reading, for the cells that report
``device_ms_per_frame``: device time under the SR head's ranges
(``sr_trunk``, ``sr_skip``, ``sr_conv``), ms a served frame."""

from vsr_bench import readers


def read(t):
    return readers.span_ms(t, ("sr_trunk", "sr_skip", "sr_conv"))

"""Device time under the SR head's ranges (``sr_trunk``, ``sr_skip``,
``sr_conv``, ``models/sr_head.py``), ms a served frame."""

from vsr_bench import readers


def read(t):
    return readers.span_ms(t, ("sr_trunk", "sr_skip", "sr_conv"))

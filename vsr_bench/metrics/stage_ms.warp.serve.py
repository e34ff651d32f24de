"""Device time under the model's ``warp`` range (the neighbours' frame or
feature and depth warp, ``models/vsr.py``), ms a served frame."""

from vsr_bench import readers


def read(t):
    return readers.span_ms(t, ("warp",))

"""Device time under SPyNet's range (``spynet``: the flows of every
neighbour pair of a clip, both ways), ms a served frame."""

from vsr_bench import readers


def read(t):
    return readers.span_ms(t, ("spynet",))

"""Device time under the propagation ranges (``propagate_backward``,
``propagate_forward``: each step's warp of the hidden state and its trunk
of 3x3 convs), ms a served frame."""

from vsr_bench import readers


def read(t):
    return readers.span_ms(t, ("propagate_backward", "propagate_forward"))

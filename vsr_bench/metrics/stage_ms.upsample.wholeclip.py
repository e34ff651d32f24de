"""Device time under the upsampler's range (``upsample``: the fusion of
the two states, the two shuffled upsample convs, ``conv_hr`` and
``conv_last`` at 4K and the bilinear skip), ms a served frame."""

from vsr_bench import readers


def read(t):
    return readers.span_ms(t, ("upsample",))

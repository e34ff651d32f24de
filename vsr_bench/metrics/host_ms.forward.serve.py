"""Host time under ``eval_step.forward`` (``api.eval_step``: the host's
issue of the model's kernels and the clamp, the model's own ranges inside
it), ms a served frame. Above the device's kernel time a frame, the
forward is launch-bound."""

from vsr_bench import spans


def read(t):
    return spans.host_ms(t, "eval_step.forward")

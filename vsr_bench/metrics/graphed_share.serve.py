"""Share of the served frames whose forward replayed CUDA graphs, %:
``api.eval_step.replays`` over ``api.eval_step.calls``, read through the
kind's ``api``. The counters run from the process's start; the warm clips
run the first call at the timed shape eagerly and capture at the second,
so the ratio is the window's less those first calls. Nothing where the
program keeps no such counters."""


def read(t):
    step = getattr(getattr(t.kind, "api", None), "eval_step", None)
    calls = getattr(step, "calls", 0)
    replays = getattr(step, "replays", None)
    if not calls or replays is None:
        return None
    return 100.0 * replays / calls

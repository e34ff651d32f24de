"""Share of the served HR frames that reached the host through a pinned
staging buffer, %: ``api.upscale_clip.frames_staged`` over
``api.upscale_clip.frames``, read through the kind's ``api``. The counters
run from the process's start; the warm clips take the timed route, so the
ratio is the window's. Nothing where the program keeps no such counters."""


def read(t):
    entry = getattr(getattr(t.kind, "api", None), "upscale_clip", None)
    frames = getattr(entry, "frames", 0)
    staged = getattr(entry, "frames_staged", None)
    if not frames or staged is None:
        return None
    return 100.0 * staged / frames

"""Share of the served HR frames written into recycled clip memory, %:
``api.upscale_clip.frames_recycled`` over ``api.upscale_clip.frames``,
read through the kind's ``api``. The counters run from the process's
start; the first warm clip allocates fresh, so the ratio is the window's
and the set-up's. Nothing where the program keeps no such counters."""


def read(t):
    entry = getattr(getattr(t.kind, "api", None), "upscale_clip", None)
    frames = getattr(entry, "frames", 0)
    recycled = getattr(entry, "frames_recycled", None)
    if not frames or recycled is None:
        return None
    return 100.0 * recycled / frames

"""Backward state a recurrent model holds for a clip, MB (1e6 bytes) a
clip: ``api.upscale_clip.state_bytes`` over ``api.upscale_clip.whole_clips``,
read through the kind's ``api``. The counters run from the process's
start, so set-up's clips count too. Nothing where the program keeps no
such counters."""


def read(t):
    entry = getattr(getattr(t.kind, "api", None), "upscale_clip", None)
    clips = getattr(entry, "whole_clips", 0)
    held = getattr(entry, "state_bytes", None)
    if not clips or held is None:
        return None
    return held / clips / 1e6

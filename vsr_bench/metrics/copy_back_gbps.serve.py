"""Rate of the HR frames' copies to the host, GB/s: bytes a frame from the
serving entry's counters (``api.upscale_clip.bytes_back`` over
``api.upscale_clip.frames``, read through the kind's ``api``) times the
window's frames, over the device time of the window's ``Memcpy DtoH``
events. The counters run from the process's start, but the warm clips run
at the timed shapes, so their ratio is the window's bytes a frame and no
reading before and after the window is needed. Nothing where the program
keeps no such counters."""

from vsr_bench import trace


def read(t):
    if not t.on_card or not t.units:
        return None
    entry = getattr(getattr(t.kind, "api", None), "upscale_clip", None)
    frames = getattr(entry, "frames", 0)
    if not frames:
        return None
    us = 0.0
    for e in t.events:
        m = trace.COPY.search(e.name)
        if m and m.group(1) == "DtoH":
            us += e.dur
    if us <= 0:
        return None
    return entry.bytes_back / frames * t.units / (us / 1e6) / 1e9

"""Device idle time inside the serving entry, ms a served frame: the
window's idle gaps (no kernel or copy running) that lie under the union of
the ``upscale_clip`` host spans (``api.upscale_clip``, one a request).
What is left of ``idle_share.serve`` times the window is the harness's own
time between requests."""

from vsr_bench import spans


def read(t):
    if not t.on_card or not t.units:
        return None
    clips = spans.merge(spans.host(t, "upscale_clip"))
    if not clips:
        return None
    return spans.total(spans.intersect(spans.idle(t), clips)) / 1e3 / t.units

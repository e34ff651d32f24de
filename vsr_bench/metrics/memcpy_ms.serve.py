"""Device time of the host-to-device and device-to-host copies (the LR
windows' uploads, the HR frames' copies back), ms a served frame."""

from vsr_bench import trace


def read(t):
    if not t.on_card or not t.units:
        return None
    return sum(e.dur for e in t.events if trace.COPY.search(e.name)) / 1e3 / t.units

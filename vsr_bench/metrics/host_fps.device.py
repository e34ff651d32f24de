"""``serve_fps`` as the traced window reads it, frames/s: every HR frame
delivered to the host over the window's whole time, under the profiler.
For the cells whose ``serve_fps`` spreads too widely between runs to hold
a bound end to end (PERF.md §2)."""


def read(t):
    return t.win.metrics.get("serve_fps")

"""Median latency of the traced run's live frames, ms: a steadier
statistic beside the tail."""

import numpy as np


def read(t):
    ms = t.win.extra.get("latency_ms")
    return float(np.median(ms)) if ms is not None and len(ms) else None

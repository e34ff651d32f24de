"""Interval arithmetic over a ``run.Traced``'s host spans and device
events, for the readers of the serving entry's ``record_function`` ranges
(``api.upscale_clip`` and ``api.eval_step``: ``upscale_clip``,
``upscale_clip.gather``, ``eval_step.upload``, ``eval_step.forward``,
``upscale_clip.stage``, ``upscale_clip.copy_back``). Times in us, as the
trace's; an interval is a (start, end) pair."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of the intervals, as sorted disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def total(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The overlap of two lists of sorted disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle(t) -> List[Interval]:
    """The device's idle gaps in the traced window: where none of its
    kernels and copies (``t.events``) ran inside [t.start, t.end]."""
    gaps, cur = [], t.start
    for s, e in merge((e.start, e.end) for e in t.events):
        if s > cur:
            gaps.append((cur, min(s, t.end)))
        cur = max(cur, e)
    if cur < t.end:
        gaps.append((cur, t.end))
    return [g for g in gaps if g[1] > g[0]]


def host(t, name: str) -> List[Interval]:
    """The host spans named ``name``, cut to the traced window."""
    return [(max(h.start, t.start), min(h.end, t.end)) for h in t.hosts
            if h.name == name and h.end > t.start and h.start < t.end]


def host_ms(t, name: str) -> Optional[float]:
    """Summed host duration of the spans named ``name`` in the window, ms
    a unit of work; nothing where the trace holds none."""
    spans = host(t, name)
    if not spans or not t.units:
        return None
    return total(spans) / 1e3 / t.units

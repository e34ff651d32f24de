"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's kernels and copies, the device-side spans of the
program's ``record_function`` ranges, the union of busy time, and the
host's activity in the device's idle gaps.

Frozen copies, so that a later change to the port cannot move the
yardstick: ``union_us`` from
``video_super_resolution_tpu_torch/tools/bench_dispatch.py``;
``device_timeline``, ``device_events``, ``device_spans``, ``check_traced``
and ``spin`` from ``video_super_resolution_tpu_torch/tools/profile_prefix.py``
(the kernel names from its ``KERNEL_NAMES``). Events are read from the
profiler's raw kineto events: ``prof.events()`` parses every host event
too, which takes tens of seconds on a trace of a few hundred train steps.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Dict, List, NamedTuple, Sequence

import torch

# the port's kernels as the device names them (csrc/*.cu), by the name of
# the program counter that counts their launches
KERNEL_NAMES = {"conv3x3": re.compile(r"\bconv3x3_kernel\b"),
                "correlation": re.compile(r"\bcorrelation_kernel\b"),
                "warp": re.compile(r"\bwarp(_pair)?_kernel\b")}
SPIN = re.compile(r"\bspin_kernel\b")      # torch.cuda._sleep's kernel
SPIN_CYCLES = 1_000_000                     # ~0.5 ms a spin kernel
COPY = re.compile(r"Memcpy (HtoD|DtoH)")


class Event(NamedTuple):
    """One event of the trace, times in us from the trace's start."""

    name: str
    id: int
    start: float
    end: float
    annotation: bool

    @property
    def dur(self) -> float:
        return self.end - self.start


def _raw(prof):
    raw = prof.profiler.kineto_results
    return raw, raw.trace_start_ns()


def device_timeline(prof) -> List[Event]:
    """Every event on the device's timeline: kernels, copies, memsets and
    the device-side spans of the ``record_function`` ranges."""
    raw, t0 = _raw(prof)
    out = []
    for e in raw.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        flag = getattr(e, "is_user_annotation", None)
        out.append(Event(e.name(), e.correlation_id(),
                         (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3,
                         bool(flag()) if flag is not None else False))
    return out


def host_events(prof) -> List[Event]:
    """Every host event: ops, ranges and CUDA runtime calls."""
    raw, t0 = _raw(prof)
    return [Event(e.name(), e.correlation_id(), (e.start_ns() - t0) / 1e3,
                  (e.end_ns() - t0) / 1e3, False)
            for e in raw.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]


def device_events(timeline: Sequence[Event]) -> List[Event]:
    """The device's kernels and copies (not the ranges annotating them, not
    the spin kernels that pad the window)."""
    return [e for e in timeline if not e.annotation and e.dur > 0
            and not SPIN.search(e.name)]


def device_spans(timeline: Sequence[Event], names: Sequence[str]
                 ) -> Dict[str, float]:
    """us of the device timeline each named range spans, summed over its
    occurrences (the device-side annotations of ``record_function``)."""
    spans = collections.Counter()
    for e in timeline:
        if e.annotation and e.name in names and e.dur > 0:
            spans[e.name] += e.dur
    return spans


def union_us(events: Sequence[Event]) -> float:
    """Length of the union of the events' time ranges (us)."""
    total, end = 0.0, None
    for s, e in sorted((e.start, e.end) for e in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def short_kernels(events: Sequence[Event], launched: Dict[str, int]
                  ) -> Dict[str, dict]:
    """``check_traced``'s test: each port kernel whose runs in the trace
    are fewer than its wrapper counted launches while it was taken (the
    profiler dropped device events, and sums over the trace read low)."""
    short = {}
    for k, pattern in KERNEL_NAMES.items():
        traced = sum(1 for e in events if pattern.search(e.name))
        if traced < launched.get(k, 0):
            short[k] = {"traced": traced, "launched": launched[k]}
    return short


def spin(seconds: float, dev: torch.device) -> None:
    """Keep the card busy for ``seconds`` s with spin kernels, then wait:
    the profiler keeps only device events stamped inside its window, and a
    kernel can be stamped before its own launch after the card sat idle."""
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize(dev)


def idle_gaps(events: Sequence[Event], hosts: Sequence[Event],
              start: float, end: float, top: int = 10,
              longest: int = 500) -> List[list]:
    """The device's idle gaps inside [start, end] (us): the ``longest``
    gaps, each named by what the host was doing at its middle (the
    innermost host event holding it, "(host outside torch)" where none does),
    summed by that name: the ``top`` largest, as [name, seconds]."""
    gaps, cur = [], start
    for s, e in sorted((e.start, e.end) for e in events):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:longest]
    hosts = sorted(hosts, key=lambda h: h.start)
    starts = [h.start for h in hosts]
    by = collections.Counter()
    for a, b in gaps:
        mid = (a + b) / 2
        best = None
        i = bisect.bisect_right(starts, mid)
        for h in reversed(hosts[max(0, i - 2000):i]):
            if h.end > mid:
                best = h          # the latest-starting event that holds it
                break
        by[best.name if best is not None else "(host outside torch)"] += \
            (b - a) / 1e6
    return [[n, s] for n, s in by.most_common(top)]


def top_ops(events: Sequence[Event], top: int = 10) -> List[list]:
    """The device operations that took most time, as [name, seconds]."""
    by = collections.Counter()
    for e in events:
        by[e.name] += e.dur / 1e6
    return [[n, s] for n, s in by.most_common(top)]

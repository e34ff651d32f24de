"""In-context cost of each stage of one composed forward, the port's
counterpart of the JAX package's ``tools/profile_prefix.py``.

    python -m video_super_resolution_tpu_torch.tools.profile_prefix \\
        [--h 540 --w 960 --n 8] [--stages flow,warp,sr_conv] [--device cpu]

``VSRConfig()`` (bf16 compute, depth at 1/2 res) with random weights from
the seed, one (1, 3, h, w, 3) window from numpy's ``default_rng(0)``, as the
JAX tool builds them; after a warm-up forward, ``n`` forwards under
``torch.profiler``. The JAX tool timed prefixes of the forward cut by
``stop_stage``, which the port leaves out: here each unit of work is
attributed to the innermost of the model's ``record_function`` ranges
(``models/vsr.py``, ``models/sr_head.py``) that encloses it, and the
stages are summed in execution order. Output lines, JAX's format:

    {"prefix": stage, "ms": cumulative, "delta_ms": the stage's own,
     "host_ms": the CPU span of its range}

a ms a forward, then ``glue`` (work outside every stage range, e.g. the
input's padding and the neighbours' stack before the flow net) and
``full`` (``ms`` = everything the trace holds, ``delta_ms`` = what no
attribution reached, ``host_ms`` = the forward's CPU span under the
profiler). So the deltas sum to the last line's ``ms``.

- On the card the work is the device's kernels and copies, each
  attributed through the host event that launched it (same CUPTI
  correlation id, launch time inside the range): ``"attribution":
  "launch"``; a kernel with no launch event counts in ``full``'s
  ``delta_ms`` (``unattributed_ms``). ``span_diff_ms`` is the largest
  difference of a stage against the device-side spans of the ranges
  (kernels run in launch order on one stream), where the trace has them.
- On the CPU (``--device cpu``, the plain versions) the work is the
  top-level PyTorch ops on the host: ``"cpu-ops"``.

Stage order: the port computes the SR head's skip before its conv (the
skip enters the conv's epilogue), so its stages run ``sr_trunk, sr_skip,
sr_conv`` where JAX's run ``sr_trunk, sr_conv, sr_skip``; JAX's
``full`` prefix is the ``full`` line. ``--stages`` picks the stage lines
printed; the work of a stage left out counts in the next line printed.
JAX's ``--warp-impl`` has no counterpart: the port has one warp (exact
for any flow).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import time
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.ops.correlation import correlation
from video_super_resolution_tpu_torch.ops.fused_conv import fused_conv3x3
from video_super_resolution_tpu_torch.ops.warp import backward_warp

STAGES = ("flow", "depth", "fd", "warp", "encode", "fusion",
          "sr_trunk", "sr_skip", "sr_conv")
# every range the model opens: "sr" holds the head's three stages
RANGES = STAGES + ("sr",)
JAX_PREFIXES = ("flow", "depth", "fd", "warp", "encode", "fusion",
                "sr_trunk", "sr_conv", "sr_skip", "full")
CALL = "profiled_call"          # the range around each profiled call
# the port's kernels: the wrapper that counts its launches, and the CUDA
# kernel that each counted launch runs once (csrc/*.cu)
WRAPPERS = {"conv3x3": fused_conv3x3, "correlation": correlation,
            "warp": backward_warp}
KERNEL_NAMES = {"conv3x3": re.compile(r"\bconv3x3_kernel\b"),
                "correlation": re.compile(r"\bcorrelation_kernel\b"),
                "warp": re.compile(r"\bwarp(_pair)?_kernel\b")}
# On the H100 (torch 2.11, CUDA 12.8) a trace now and then lacks device
# events, the first kernels of the trace or all of a short one, and a
# kernel can be stamped ms before its own launch, more so after the card
# sat idle (tools/trace_check.py, PERF.md): the profiler keeps only the
# device events stamped inside its window. So the card spins LEADS[i] s
# at each end of the window, and a short trace is taken again with the
# next lead.
LEADS = (0.05, 0.25, 1.0)
TRACES = len(LEADS)
SPIN_CYCLES = 1_000_000     # a spin kernel: ~0.5 ms on the card
SPIN = re.compile(r"\bspin_kernel\b")     # torch.cuda._sleep's kernel

_CUDA = torch.autograd.DeviceType.CUDA
_CPU = torch.autograd.DeviceType.CPU


class Span(NamedTuple):
    start: float
    end: float


class DeviceEvent(NamedTuple):
    """An event on the device's timeline as the profiler's event list
    gives it (``time_range`` in us from the trace's start, ``id`` its
    CUPTI correlation id), read from the profiler's raw events: the list
    also parses every host event, which on the H100 made a trace of 20
    train steps take tens of seconds more (PERF.md)."""

    name: str
    id: int
    time_range: Span
    is_user_annotation: bool


def device_timeline(prof) -> List[DeviceEvent]:
    """Every event on the device's timeline: kernels, copies and the
    device-side spans of the ``record_function`` ranges."""
    raw = prof.profiler.kineto_results
    t0 = raw.trace_start_ns()
    out = []
    for e in raw.events():
        if e.device_type() != _CUDA:
            continue
        flag = getattr(e, "is_user_annotation", None)
        annotation = flag() if flag is not None else (
            e.name() in RANGES + (CALL,))
        out.append(DeviceEvent(e.name(), e.correlation_id(),
                               Span((e.start_ns() - t0) / 1e3,
                                    (e.end_ns() - t0) / 1e3), annotation))
    return out


def device_events(prof) -> List[DeviceEvent]:
    """The device's kernels and copies in a profile (not the ranges that
    annotate them on the device's timeline)."""
    return [e for e in device_timeline(prof)
            if not e.is_user_annotation and _dur(e) > 0
            and not SPIN.search(e.name)]


def launch_counts() -> Dict[str, int]:
    """Each port kernel's wrapper count of launches."""
    return {k: fn.launches for k, fn in WRAPPERS.items()}


def lost_launches(prof) -> dict:
    """The host's kernel launches in a trace and those whose kernel the
    trace lacks (same CUPTI correlation id), each as (its place among the
    launches, us after the trace's start); and the us after the trace's
    start of its first device event."""
    raw = prof.profiler.kineto_results
    t0 = raw.trace_start_ns()
    events = list(raw.events())
    ran = {e.correlation_id() for e in events if e.device_type() == _CUDA}
    launches = sorted(e.start_ns() for e in events
                      if e.device_type() != _CUDA
                      and "LaunchKernel" in e.name())
    lost = sorted(e.start_ns() for e in events
                  if e.device_type() != _CUDA and "LaunchKernel" in e.name()
                  and e.correlation_id() not in ran)
    first = min((e.start_ns() for e in events if e.device_type() == _CUDA),
                default=None)
    return {"launches": len(launches),
            "lost": [(launches.index(t), (t - t0) / 1e3) for t in lost],
            "first_device_us": None if first is None else (first - t0) / 1e3,
            "first_launch_us": (launches[0] - t0) / 1e3 if launches else None}


class ShortTrace(RuntimeError):
    """A trace that lacks device events: ``short`` by kernel, ``prof``
    the trace."""

    def __init__(self, prof, short: Dict[str, dict], n_events: int):
        where = lost_launches(prof)
        where["lost"] = where["lost"][:8]
        super().__init__(f"the trace lacks device events: {short} (of "
                         f"{n_events} device events traced; {where})")
        self.prof, self.short = prof, short


def check_traced(prof, launched: Dict[str, int]) -> None:
    """Raise ShortTrace when the trace holds fewer runs of a port kernel
    than its wrapper counted launches while the trace was taken: the
    profiler dropped device events, and every sum over the trace would
    read low."""
    names = [e.name for e in device_events(prof)]
    short = {}
    for k, pattern in KERNEL_NAMES.items():
        traced = sum(1 for name in names if pattern.search(name))
        if traced < launched.get(k, 0):
            short[k] = {"traced": traced, "launched": launched[k]}
    if short:
        raise ShortTrace(prof, short, len(names))


def device_spans(prof, names: Sequence[str] = RANGES) -> Dict[str, float]:
    """us of the device timeline each named range spans (the device-side
    annotations of ``record_function``), summed over its occurrences."""
    spans = collections.Counter()
    for e in device_timeline(prof):
        if e.name in names and _dur(e) > 0:
            spans[e.name] += _dur(e)
    return spans


def _dur(e) -> float:
    return e.time_range.end - e.time_range.start


def _annotation(e) -> bool:
    return getattr(e, "is_user_annotation", False)


def _innermost(ranges: List[tuple], t: float) -> Optional[str]:
    """Name of the innermost (latest-starting) of the (start, end, name)
    ranges that holds time t."""
    best = None
    for start, end, name in ranges:
        if start <= t < end and (best is None or start >= best[0]):
            best = (start, name)
    return None if best is None else best[1]


def _stage(name: Optional[str]) -> str:
    return name if name in STAGES else "glue"


def cpu_ops(events) -> list:
    """Top-level PyTorch ops on the host: no op above them, only ranges."""
    out = []
    for e in events:
        if (e.device_type != _CPU or _annotation(e) or _dur(e) <= 0
                or e.name in RANGES or e.name == CALL):
            continue
        p = e.cpu_parent
        while p is not None and (p.name in RANGES or p.name == CALL):
            p = p.cpu_parent
        if p is None:
            out.append(e)
    return out


def attribute(prof, on_device: bool) -> dict:
    """Per-stage work (us) by the innermost enclosing range, host spans of
    the ranges (us), glue, the total, and how the work was attributed."""
    events = list(prof.events())
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == _CPU and e.name in RANGES + (CALL,)]
    host.sort()
    order = []
    for _, _, name in host:
        if name in STAGES and name not in order:
            order.append(name)
    host_us = collections.Counter()
    for start, end, name in host:
        host_us[name] += end - start
    work = collections.Counter()
    unattributed, span_diff = 0.0, None
    if on_device:
        kernels = device_events(prof)
        launches = {e.id: e for e in events if e.device_type == _CPU
                    and e.name.startswith("cu") and not _annotation(e)}
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in device_timeline(prof)
                       if e.name in RANGES and _dur(e) > 0)
        how = "launch"
        by_span = collections.Counter()
        for k in kernels:
            launch = launches.get(k.id)
            if launch is None:
                unattributed += _dur(k)
                continue
            work[_stage(_innermost(host, launch.time_range.start))] += _dur(k)
            by_span[_stage(_innermost(spans, k.time_range.start))] += _dur(k)
        if spans:
            span_diff = max((abs(work[s] - by_span[s])
                             for s in set(work) | set(by_span)), default=0.0)
        total = sum(_dur(k) for k in kernels)
    else:
        how = "cpu-ops"
        ops = cpu_ops(events)
        for op in ops:
            work[_stage(_innermost(host, op.time_range.start))] += _dur(op)
        total = sum(_dur(op) for op in ops)
    return {"order": order, "work_us": work, "host_us": host_us,
            "total_us": total, "unattributed_us": unattributed,
            "attribution": how, "span_diff_us": span_diff}


def spin(seconds: float, dev: torch.device) -> None:
    """Keep the card busy for ``seconds`` s with spin kernels, then wait
    for it; ``device_events`` leaves the spin kernels out."""
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize(dev)


def trace_once(fn: Callable[[], object], n: int, dev: torch.device,
               lead: float = 0.0):
    """``n`` calls of fn, each in a CALL range, under torch.profiler (the
    device too on a card, which spins ``lead`` s before the first call and
    after the last): the profiler and each port kernel's launches counted
    while it ran."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize(dev)
    before = launch_counts()
    with profile(activities=acts) as prof:
        if card:
            spin(lead, dev)
        for _ in range(n):
            with record_function(CALL):
                fn()
        if card:
            torch.cuda.synchronize(dev)
            spin(lead, dev)
    return prof, {k: v - before[k] for k, v in launch_counts().items()}


def profiled(fn: Callable[[], object], n: int, dev: torch.device):
    """The profiler of ``trace_once(fn, n, dev, lead)``. On a card the
    trace must hold every counted launch of the port's kernels
    (``check_traced``): one that does not is taken again with the next of
    LEADS (a warning says what it lacked), and the last raises
    ShortTrace."""
    for i, lead in enumerate(LEADS):
        prof, launched = trace_once(fn, n, dev, lead)
        if dev.type != "cuda":
            return prof
        try:
            check_traced(prof, launched)
            return prof
        except ShortTrace as e:
            if i == TRACES - 1:
                raise
            warnings.warn(f"{e}; tracing again with a {LEADS[i + 1]} s "
                          f"lead (trace {i + 2} of {TRACES})")


def make_window(cfg: VSRConfig, h: int, w: int, batch: int = 1
                ) -> torch.Tensor:
    """The (batch, T, h, w, 3) f32 window of the JAX tools and bench
    (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.random((batch, cfg.model.window, h, w, 3))
                            ).to(torch.float32)


def prefix_lines(a: dict, n: int, stages: Optional[Sequence[str]] = None
                 ) -> List[dict]:
    """JAX's prefix lines (ms a call) from ``attribute``'s result."""
    want = list(stages) if stages else list(a["order"])
    bad = [s for s in want if s not in a["order"]]
    if bad:
        raise ValueError(f"no stage {bad} in this forward (stages: "
                         f"{a['order']})")
    lines, cum, prev = [], 0.0, 0.0
    for s in a["order"]:
        cum += a["work_us"][s] / n / 1e3
        if s in want:
            lines.append({"prefix": s, "ms": cum, "delta_ms": cum - prev,
                          "host_ms": a["host_us"][s] / n / 1e3})
            prev = cum
    cum += a["work_us"]["glue"] / n / 1e3
    glue_host = a["host_us"][CALL] - sum(a["host_us"][s] for s in STAGES)
    lines.append({"prefix": "glue", "ms": cum, "delta_ms": cum - prev,
                  "host_ms": glue_host / n / 1e3})
    full = a["total_us"] / n / 1e3
    lines.append({"prefix": "full", "ms": full, "delta_ms": full - cum,
                  "host_ms": a["host_us"][CALL] / n / 1e3,
                  "unattributed_ms": a["unattributed_us"] / n / 1e3,
                  "attribution": a["attribution"],
                  "span_diff_ms": (None if a["span_diff_us"] is None
                                   else a["span_diff_us"] / n / 1e3)})
    return lines


def run(h: int = 540, w: int = 960, n: int = 8, device: api.Device = "cuda",
        stages: Optional[Sequence[str]] = None,
        cfg: Optional[VSRConfig] = None,
        emit: Callable[[str], None] = print) -> List[dict]:
    """The prefix lines of ``n`` profiled forwards of ``cfg`` (default
    ``VSRConfig()``, weights from seed 0) on one (1, T, h, w, 3) window;
    each line is emitted as JSON as it is made, the last with the device's
    label."""
    from video_super_resolution_tpu_torch.tools.quality_serving import device_label

    dev = api.resolve_device(device)
    cfg = cfg or VSRConfig()
    model = api.build_model(cfg, dev)
    window = make_window(cfg, h, w).to(dev)
    api.upscale_window(model, window)                   # warm-up
    prof = profiled(lambda: api.upscale_window(model, window), n, dev)
    lines = prefix_lines(attribute(prof, dev.type == "cuda"), n, stages)
    lines[-1]["device"] = device_label(dev)
    for line in lines:
        emit(json.dumps(line))
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=540)
    ap.add_argument("--w", type=int, default=960)
    ap.add_argument("--n", type=int, default=8, help="profiled forwards")
    ap.add_argument("--stages", default="",
                    help="comma list of stage lines; empty = all")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.h, args.w, args.n, args.device,
        [s for s in args.stages.split(",") if s] or None)
    return 0


if __name__ == "__main__":
    sys.exit(main())

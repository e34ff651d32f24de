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
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig

STAGES = ("flow", "depth", "fd", "warp", "encode", "fusion",
          "sr_trunk", "sr_skip", "sr_conv")
# every range the model opens: "sr" holds the head's three stages
RANGES = STAGES + ("sr",)
JAX_PREFIXES = ("flow", "depth", "fd", "warp", "encode", "fusion",
                "sr_trunk", "sr_conv", "sr_skip", "full")
CALL = "profiled_call"          # the range around each profiled call

_CUDA = torch.autograd.DeviceType.CUDA
_CPU = torch.autograd.DeviceType.CPU


def device_events(prof) -> list:
    """The device's kernels and copies in a profile (not the ranges that
    annotate them on the device's timeline)."""
    return [e for e in prof.events()
            if e.device_type == _CUDA
            and not _annotation(e) and e.time_range.end > e.time_range.start]


def device_spans(prof, names: Sequence[str] = RANGES) -> Dict[str, float]:
    """us of the device timeline each named range spans (the device-side
    annotations of ``record_function``), summed over its occurrences."""
    spans = collections.Counter()
    for e in prof.events():
        if (e.name in names and e.device_type == _CUDA
                and e.time_range.end > e.time_range.start):
            spans[e.name] += e.time_range.end - e.time_range.start
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
                       for e in events if e.device_type == _CUDA
                       and e.name in RANGES and _dur(e) > 0)
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


def profiled(fn: Callable[[], object], n: int, dev: torch.device):
    """``n`` calls of fn, each in a CALL range, under torch.profiler (the
    device too on a card); returns the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with profile(activities=acts) as prof:
        for _ in range(n):
            with record_function(CALL):
                fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return prof


def make_window(cfg: VSRConfig, h: int, w: int) -> torch.Tensor:
    """The (1, T, h, w, 3) f32 window of the JAX tools (``default_rng(0)``)."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.random((1, cfg.model.window, h, w, 3))
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

"""How often a ``torch.profiler`` trace on this card lacks a kernel the
port launched, and how far its kernels' stamps run ahead of their launches.

    python -m video_super_resolution_tpu_torch.tools.trace_check \\
        [--procs 2] [--traces 200] [--lead 0.05]

``--procs`` fresh processes; each builds ``VSRConfig()`` (bf16, seeded
random weights) and ``profile_model``'s stages on a 540x960 window, takes
their back-to-back times as ``profile_model`` does, traces every stage
once (8 calls a trace, ``profile_prefix.trace_once`` with the card
spinning ``--lead`` s at each end, ``profile_prefix.LEADS[0]`` by
default: one trace, never taken again), then the warp stage (8 launches
of one short kernel) ``--traces`` times. A trace is short when it holds fewer runs of a port
kernel than its wrapper counted (``profile_prefix.check_traced``). Its
skew is the least (kernel start - start of the host launch with the same
correlation id), in us: a kernel cannot start before its launch, so a
negative skew is the clock's.

One JSON line a process: ``lead``, ``traces``, ``short`` (the warp traces),
``stage_short`` (the stage traces, with what each lacked),
``skew_min_us``, ``skew_q01_us``, ``skew_median_us``, ``skew_negative``
(traces with a negative skew); then a line with the sums. The card only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from typing import List, Optional, Sequence

import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.tools import profile_model as pm
from video_super_resolution_tpu_torch.tools import profile_prefix as pp

MODULE = "video_super_resolution_tpu_torch.tools.trace_check"
CALLS = 8       # calls a trace, as profile_model's


def skew_us(prof) -> Optional[float]:
    """The least kernel start - launch start in the trace (us)."""
    cpu = torch.autograd.DeviceType.CPU
    launch = {e.id: e.time_range.start for e in prof.events()
              if e.device_type == cpu and "Launch" in e.name}
    skews = [e.time_range.start - launch[e.id] for e in pp.device_events(prof)
             if e.id in launch]
    return min(skews) if skews else None


def trace(fn, args, dev: torch.device, lead: float):
    """(short by kernel or None, skew) of one trace of CALLS calls."""
    with torch.no_grad():
        prof, launched = pp.trace_once(lambda: fn(*args), CALLS, dev, lead)
    try:
        pp.check_traced(prof, launched)
        return None, skew_us(prof)
    except pp.ShortTrace as e:
        return e.short, skew_us(prof)


def one(traces: int, lead: float) -> dict:
    """One process's line."""
    dev = api.resolve_device("cuda")
    model = api.build_model(VSRConfig(), dev)
    todo = pm.stages(model, pm.make_inputs(model, 540, 960), 540, 960)
    for _, fn, args in todo:
        pm.back_to_back_ms(fn, args, CALLS, dev)
    skews: List[float] = []
    stage_short = {}
    for name, fn, args in todo:
        short, sk = trace(fn, args, dev, lead)
        if short:
            stage_short[name] = short
        if sk is not None:
            skews.append(sk)
    _, warp, args = next(t for t in todo if t[0].startswith("warp"))
    n_short = 0
    for _ in range(traces):
        short, sk = trace(warp, args, dev, lead)
        n_short += bool(short)
        if sk is not None:
            skews.append(sk)
    skews.sort()
    return {"lead": lead, "traces": traces, "short": n_short,
            "stage_short": stage_short, "skew_min_us": skews[0],
            "skew_q01_us": skews[len(skews) // 100],
            "skew_median_us": skews[len(skews) // 2],
            "skew_negative": sum(1 for v in skews if v < 0),
            "skew_traces": len(skews)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--traces", type=int, default=200)
    ap.add_argument("--lead", type=float, default=pp.LEADS[0])
    ap.add_argument("--one", action="store_true",
                    help=argparse.SUPPRESS)     # a child process
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.traces, args.lead)), flush=True)
        return 0
    lines = []
    for _ in range(args.procs):
        out = subprocess.run(
            [sys.executable, "-m", MODULE, "--one", "--traces",
             str(args.traces), "--lead", str(args.lead)],
            check=True, capture_output=True, text=True).stdout
        lines.append(json.loads(out.strip().splitlines()[-1]))
        print(json.dumps(lines[-1]), flush=True)
    print(json.dumps({
        "lead": args.lead, "processes": len(lines), "short": sum(r["short"] for r in lines),
        "traces": sum(r["traces"] for r in lines),
        "stage_short": sum(len(r["stage_short"]) for r in lines),
        "stage_traces": len(lines) * len(pm.JAX_STAGES[:-1]),
        "skew_min_us": min(r["skew_min_us"] for r in lines),
        "skew_negative": sum(r["skew_negative"] for r in lines),
        "skew_traces": sum(r["skew_traces"] for r in lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

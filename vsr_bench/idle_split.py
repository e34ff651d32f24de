"""Where a serving cell's device idle time goes, from one traced window in
one process (set up and measured as ``run`` does with ``--trace 1``):

    python3 -m vsr_bench.idle_split --workload espcn.clip.540p --seed N \\
        [--seconds 30]
    python3 -m vsr_bench.idle_split --span-cost 100000

One JSON line: ``serve_fps`` of the traced window; the cell's per-layer
metrics; ``idle_ms``, the window's device idle time a frame split by the
serving entry's ranges (``api.upscale_clip``, ``api.eval_step``): under
each of the five inner ranges, under the rest of ``upscale_clip``, and
``harness`` (outside every ``upscale_clip``: the harness between
requests), with their ``sum`` and ``idle_share.serve`` times the window a
frame for a check; the harness's ``idle_gaps`` breakdown; and ``skew``,
each window kernel's and copy's device start less the start of its launch
on the host (the runtime call with the same correlation id), in us: a
negative skew is the clocks', and bounds how precisely a gap's edges fall
among the host's ranges. ``--span-cost N``: us a ``record_function``
enter and exit takes with no profiler active, the mean over N.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from torch.profiler import record_function

from vsr_bench import readers, spans, weights
from vsr_bench import run as harness

INNER = ("upscale_clip.gather", "eval_step.upload", "eval_step.forward",
         "upscale_clip.stage", "upscale_clip.copy_back")


def split_ms(t) -> dict:
    """Device idle ms a frame under each inner range, the rest of the
    ``upscale_clip`` ranges, and outside them."""
    idle = spans.idle(t)
    clips = spans.intersect(idle, spans.merge(spans.host(t, "upscale_clip")))
    out = {}
    for name in INNER:
        out[name] = spans.total(spans.intersect(
            clips, spans.merge(spans.host(t, name)))) / 1e3 / t.units
    out["upscale_clip.rest"] = spans.total(clips) / 1e3 / t.units - sum(
        out.values())
    out["harness"] = (spans.total(idle) - spans.total(clips)) / 1e3 / t.units
    out["sum"] = sum(out.values())
    out["idle_share_x_window"] = (readers.idle_share(t) / 100 * t.window_s
                                  * 1e3 / t.units)
    return out


def skew_us(t) -> dict:
    """Device start - host launch start of the window's kernels and copies."""
    launch = {h.id: h.start for h in t.hosts if h.name.startswith("cuda")}
    sk = sorted(e.start - launch[e.id] for e in t.events if e.id in launch)
    if not sk:
        return {"matched": 0}
    return {"matched": len(sk), "of": len(t.events),
            "negative": sum(1 for v in sk if v < 0), "min": sk[0],
            "q01": sk[len(sk) // 100], "median": sk[len(sk) // 2]}


def span_cost_us(n: int) -> float:
    t = time.perf_counter()
    for _ in range(n):
        with record_function("upscale_clip.gather"):
            pass
    return (time.perf_counter() - t) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--span-cost", type=int, default=0)
    args = ap.parse_args(argv)
    if args.span_cost:
        span_cost_us(1000)
        print(json.dumps({"span_us": span_cost_us(args.span_cost),
                          "calls": args.span_cost}), flush=True)
        return 0
    r, run = harness.prepare(args.workload, args.seed)
    kind = r["kind"]
    run.weights = weights.for_run(run)
    st = kind.setup(run)
    win, t = harness.measure(kind, st, args.seconds, True, run)
    metrics = {m["name"]: harness.load_metric(m["name"])(t)
               for m in r["per_layer"]}
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "frames": win.units, "window_s": t.window_s,
                      "busy_s": t.busy_us() / 1e6, **win.metrics,
                      "metrics": metrics, "idle_ms": split_ms(t),
                      "idle_gaps": t.breakdown()["idle_gaps"],
                      "skew_us": skew_us(t), "trace_short": t.short}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

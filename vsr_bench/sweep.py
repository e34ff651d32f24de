"""The highest rate a live cell's stream is served at without a growing
backlog, by a sweep of fixed arrival rates in one process:

    python3 -m vsr_bench.sweep --workload espcn.live.540p --seed N \\
        --rates 6,8,10,12 [--seconds 20]

One JSON line a rate: the frames, the achieved rate, the latency's
median and 95th percentile, and the median latency of the window's first
and last quarter of frames. A rate is sustained where the last quarter's
median is within 25 % (and 10 ms) of the first quarter's: the queue does
not grow over the window.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from vsr_bench import run as harness
from vsr_bench import weights


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    r, run = harness.prepare(args.workload, args.seed,
                             spec=harness.load_spec(later=True))
    kind = r["kind"]
    run.weights = weights.for_run(run)
    st = kind.setup(run)
    for rate in (float(x) for x in args.rates.split(",")):
        run.traffic["rate_fps"] = rate
        win = kind.window(st, args.seconds)
        ms = win.extra["latency_ms"]
        q = max(1, len(ms) // 4)
        first, last = float(np.median(ms[:q])), float(np.median(ms[-q:]))
        print(json.dumps({
            "rate_fps": rate, "frames": win.units,
            "achieved_fps": win.units / win.seconds,
            "p50_ms": float(np.median(ms)),
            "p95_ms": float(np.percentile(ms, 95)),
            "first_quarter_ms": first, "last_quarter_ms": last,
            "sustained": last <= max(1.25 * first, first + 10.0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

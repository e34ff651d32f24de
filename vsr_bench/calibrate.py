"""The readings that the limits of a cell's correctness check are set
from, in one process (so the set-up and the kernel build are paid once):

    python3 -m vsr_bench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--faults half_batch:7,8,9] \\
        [--seconds 10] [--out chiprun_out/calibrate.jsonl]

For each seed, one run of the port as the benchmark runs it, at the cell's
own load (``--seconds``), with no limit; for each control seed, one run
with the control in the port's place (``Run.program == "control"``: the
reference at fp8, the next precision below the configuration's bf16);
for each fault and its seeds, one run of the port with that fault planted
(``Run.fault``). One JSON line a run, then one line a number: the largest
reading of the port (the lower reading), the smallest of the control and
of each fault. A limit lies between the lower reading and the least of
the upper ones that reach three times it (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from vsr_bench import run as harness


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="",
                    help="name:seed,seed;name:seed,... planted faults")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seconds", type=float, default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    runs = [("port", None, s) for s in _ints(args.seeds)]
    runs += [("control", None, s) for s in _ints(args.control_seeds)]
    for item in filter(None, args.faults.split(";")):
        name, seeds = item.split(":")
        runs += [("port", name, s) for s in _ints(seeds)]
    spec = harness.load_spec(later=True)
    unlimited = {k: float("inf")
                 for k in harness.resolve(spec, args.workload)["limits"]}
    readings = {}
    out = open(args.out, "a") if args.out else None
    for program, fault, seed in runs:
        seconds = (args.control_seconds if program == "control"
                   and args.control_seconds is not None else args.seconds)
        t = time.time()
        res = harness.run_cell(args.workload, seed, seconds, spec=spec,
                               limits=unlimited, program=program, fault=fault,
                               t_start=t)
        label = program if fault is None else f"fault:{fault}"
        line = {"workload": args.workload, "seed": seed, "reading": label,
                "checks": {k: c["value"] for k, c in res["checks"].items()},
                "metrics": {k: m["value"] for k, m in res["metrics"].items()},
                "attempted": res["attempted"], "phases": res["phases"],
                "detail": res.get("detail"),
                "wall_s": time.time() - t}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for k, v in line["checks"].items():
            readings.setdefault(label, {}).setdefault(k, []).append(v)
    for label, nums in readings.items():
        for k, vals in nums.items():
            pick = max if label == "port" else min
            print(json.dumps({"workload": args.workload, "reading": label,
                              "number": k, "n": len(vals),
                              "max" if label == "port" else "min": pick(vals),
                              "all": vals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m vsr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run loads the cell's configuration, traffic and limits by name, makes
the weights and inputs from the seed, lets the traffic's kind set up the
port and warm up every shape it will use (``setup_s``: from the process's
start to the window's first request), measures for ``--seconds``
(``--trace 1``: under ``torch.profiler``, for the per-layer metrics;
``--trace 0`` in a cell with an end-to-end metric read from the device's
trace: under its device activity alone), then
frees the program and checks what its timed path produced against the
plain reference (``correct``). It refuses to run without a CUDA card, and
fails when a module named ``jax``, ``jaxlib``, ``flax`` or
``video_super_resolution_tpu`` has been imported.
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every kernel and build cache at one fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".vsr_bench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".vsr_bench_cache",
                                                  "torch_extensions")

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

import torch  # noqa: E402

from vsr_bench import roofline, trace, weights  # noqa: E402
from vsr_bench.cell import Run, Window  # noqa: E402

BENCH = os.path.join(ROOT, "BENCHMARK.json")
HERE = os.path.dirname(os.path.abspath(__file__))
BANNED = ("jax", "jaxlib", "flax", "video_super_resolution_tpu")
WINDOW = "vsr_bench.window"     # the range around the measured window
LEAD_S = 0.25                   # the card spins this long at each end of a trace


def process_start() -> float:
    """The process's start on ``time.time()``'s clock (10 ms steps), or
    this module's import where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(later: bool = False) -> dict:
    """BENCHMARK.json; with ``later``, also the cells of ``later.json``
    (proven on the card, kept out of the benchmark), for the builder's
    tools and the tests."""
    spec = _load_json(BENCH)
    if later:
        extra = _load_json(os.path.join(HERE, "later.json"))
        for key in ("workloads", "end_to_end", "per_layer"):
            spec[key] = spec[key] + extra[key]
    return spec


def resolve(spec: dict, name: str) -> dict:
    """The cell ``name``'s entry, configuration, traffic, limits, kind
    module, plain reference (the module ``reference/<name>.py`` that the
    configuration file's ``reference`` names) and per-layer metrics, all
    found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(has {sorted(cells)})")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = _load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = _load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = _load_json(os.path.join(HERE, "limits", name + ".json"))
    kind = importlib.import_module(f"vsr_bench.kinds.{traffic['kind']}")
    reference = importlib.import_module(
        f"vsr_bench.reference.{config['reference']}")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "kind": kind, "reference": reference,
            "end_to_end": e2e,
            "per_layer": layer}


def load_metric(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "vsr_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Traced:
    """The traced window, as the per-layer readers see it: the device's
    kernels and copies inside the window, its device-side range spans, its
    length, the units of work done in it, and the cell's work per unit
    (operations and the floor of its convs) from the run's reference
    on the meta device."""

    def __init__(self, run: Run, kind, win: Window, prof, launched: dict):
        self.run, self.kind, self.win = run, kind, win
        self.on_card = run.device.type == "cuda"
        timeline = trace.device_timeline(prof) if self.on_card else []
        hosts = trace.host_events(prof)
        span = [h for h in hosts if h.name == WINDOW]
        if span:
            self.start, self.end = span[0].start, span[0].end
        else:
            # a device-only profile records no host range: the window is
            # what the device ran between the spin kernels at its ends
            work = trace.device_events(timeline)
            self.start = min((e.start for e in work), default=0.0)
            self.end = max((e.end for e in work), default=0.0)
        self.window_s = (self.end - self.start) / 1e6
        inside = [e for e in timeline if e.end > self.start and e.start < self.end]
        self.timeline = inside
        self.events = [trace.Event(e.name, e.id, max(e.start, self.start),
                                   min(e.end, self.end), e.annotation)
                       for e in trace.device_events(inside)]
        # the window's own range holds every gap: leave it out of the names
        self.hosts = [h for h in hosts if h.end > self.start
                      and h.start < self.end and h.name != WINDOW]
        self.short = trace.short_kernels(self.events, launched)
        self.units = win.units
        self._work = None

    def busy_us(self) -> float:
        return trace.union_us(self.events)

    def spans_us(self, names) -> float:
        return sum(trace.device_spans(self.timeline, names).values())

    def work(self) -> dict:
        """{"flops": operations a unit, "conv_floor_ms": the least time of
        every conv the reference records in a unit, each at its kernel
        size} at the cell's shapes."""
        if self._work is None:
            fn = self.kind.work(self.run)
            ref = self.run.reference
            flops = roofline.flops(lambda: fn(ref.Ops()))
            ops = ref.Ops(record=True)
            fn(ops)
            compute = 2 if self.run.train["compute_dtype"] in (
                "bfloat16", "float16") else 4
            # (b, h, w, cin, cout, f32[, k]): no k is a 3x3 conv
            floor = sum(roofline.conv_roofline_ms(
                b, h, w, cin, cout, k[0] if k else 3,
                4 if f32 else compute)["floor_ms"]
                for b, h, w, cin, cout, f32, *k in ops.convs)
            self._work = {"flops": flops, "conv_floor_ms": floor}
        return self._work

    def breakdown(self) -> dict:
        return {"device_ops": trace.top_ops(self.events),
                "idle_gaps": trace.idle_gaps(self.events, self.hosts,
                                             self.start, self.end)}


def measure(kind, state, seconds: float, traced: bool, run: Run,
            device_only: bool = False):
    """The kind's window, under the profiler when ``traced``. With
    ``device_only`` (a cell with an end-to-end metric read from the
    device's trace) an untraced window on a card runs under the profiler's
    device activity alone, which records no host op or range."""
    card = run.device.type == "cuda"
    if not traced and not (device_only and card):
        return kind.window(state, seconds), None
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = (([ProfilerActivity.CPU] if traced else [])
            + ([ProfilerActivity.CUDA] if card else []))
    before = kind.launches()
    with profile(activities=acts) as prof:
        if card:
            trace.spin(LEAD_S, run.device)
        with record_function(WINDOW):
            win = kind.window(state, seconds)
        if card:
            torch.cuda.synchronize(run.device)
            trace.spin(LEAD_S, run.device)
    after = kind.launches()
    launched = {k: after[k] - before.get(k, 0) for k in after}
    return win, Traced(run, kind, win, prof, launched)


def device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def prepare(name: str, seed: int, device: str = "cuda",
            spec: Optional[dict] = None,
            config_overrides: Optional[dict] = None,
            traffic_overrides: Optional[dict] = None,
            limits: Optional[dict] = None, program: str = "port",
            fault: Optional[str] = None):
    """``resolve``'s entries of cell ``name`` and the ``Run`` of one run of
    it (without its weights)."""
    r = resolve(spec or load_spec(), name)
    config = r["config"]
    if config_overrides:
        config = json.loads(json.dumps(config))
        for group, fields in config_overrides.items():
            config["vsr_config"][group].update(fields)
    run = Run(name, r["cell"], config,
              {**r["traffic"], **(traffic_overrides or {})},
              limits if limits is not None else r["limits"], seed,
              torch.device(device), r["reference"], program=program,
              fault=fault)
    return r, run


def run_cell(name: str, seed: int, seconds: float, traced: bool = False, *,
             device: str = "cuda", spec: Optional[dict] = None,
             config_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None,
             limits: Optional[dict] = None, program: str = "port",
             fault: Optional[str] = None, t_start: Optional[float] = None
             ) -> dict:
    """One run of cell ``name``: the result line as a dict (its "checks"
    hold each compared number beside its limit). The overrides, the
    limits, ``program`` and ``fault`` serve the calibration and the tests;
    the command line passes none of them."""
    t_start = process_start() if t_start is None else t_start
    r, run = prepare(name, seed, device, spec, config_overrides,
                     traffic_overrides, limits, program, fault)
    kind = r["kind"]
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    t = time.time()
    run.phases["before_weights"] = t - t_start
    run.weights = weights.for_run(run)
    run.phases["weights"] = time.time() - t
    t = time.time()
    state = kind.setup(run)
    run.phases["kind_setup"] = time.time() - t
    setup_s = time.time() - t_start

    device_e2e = {m["name"] for m in r["end_to_end"]
                  if m["source"] == "device_trace"}
    win, traced_view = measure(kind, state, seconds, traced, run,
                               device_only=bool(device_e2e))
    device = device_info(run.device)
    kind.release(state)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.time()
    checks = kind.check(state, win)
    run.phases["check"] = time.time() - t
    correct = (win.attempted > 0 and win.failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))  # NaN fails

    metrics = {}
    units = {m["name"]: m["unit"] for m in r["end_to_end"] + r["per_layer"]}
    if not traced:
        values = dict(win.metrics, setup_s=setup_s)
        for m in r["end_to_end"]:
            if m["name"] not in device_e2e:
                value = values[m["name"]]
            elif traced_view is not None:
                value = load_metric(m["name"])(traced_view)
            else:       # no card, no device trace: not measured
                value = None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in r["per_layer"]:
            value = load_metric(m["name"])(traced_view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device["busy_s"] = traced_view.busy_us() / 1e6
        device["window_s"] = traced_view.window_s
    out = {"correct": bool(correct), "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": device}
    if traced:
        out["breakdown"] = traced_view.breakdown()
    if traced_view is not None and traced_view.short:
        out["trace_short"] = traced_view.short
    out["phases"] = run.phases
    if getattr(state, "detail", None) is not None:
        out["detail"] = state.detail
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def _finite(v: float):
    """A number JSON can hold: NaN and infinities as strings."""
    return v if v == v and abs(v) != float("inf") else str(v)


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    chips = resolve(spec, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"vsr_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   spec=spec, t_start=t_start)
    found = banned_modules()
    if found:
        print(f"vsr_bench: the run imported {found}", file=sys.stderr)
        return 3
    print(f"phases {json.dumps(out.pop('phases'))}", file=sys.stderr)
    out.pop("detail", None)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

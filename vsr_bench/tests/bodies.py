"""What the harness tests check of one cell, as plain functions of
``(spec, cell, sizes)``, so that a test can run them for any cell of any
spec, also one that is not in BENCHMARK.json.

A cell's test sizes are found by name, as the harness finds its files
(``sizes``): ``sizes/kinds/<kind>.json`` for its traffic's kind and
``sizes/references/<reference>.json`` for its configuration's reference.
A kind's file holds

- ``tiny``: the traffic overrides of the runs on the CPU;
- ``card`` and ``control``: those of the sound run and of the control's
  runs on the card (``on_card_small``, ``control_fails_on_card``);
- ``faults``: the faults the kind plants (``Run.fault``), each of which
  a run has to fail;
- ``clock_step``: where a tiny window on a loaded CPU would do too little
  work to show a fault, the seconds by which a reading of the kind
  module's ``time.perf_counter`` moves in the CPU runs; else null;
- ``unit``: what one unit of the kind's work is (``frame``, ``step``).

A reference's file holds ``model``, the tiny widths of the CPU runs (the
CPU runs compute in f32), and may hold ``unit_flops``: by unit, the
bounds of the operations of one unit at a cell's own traffic.
"""

from __future__ import annotations

import json
import os
import types
from typing import Optional
from unittest import mock

from vsr_bench import run
from vsr_bench.cell import Window
from vsr_bench.tests.conftest import EmptyProfile

SIZES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sizes")
SEED = 2 ** 31 + 11
TRAIN = {"compute_dtype": "float32"}      # every tiny run's


def load(*parts) -> dict:
    """The sizes file at ``sizes/<parts>``."""
    with open(os.path.join(SIZES, *parts)) as f:
        return json.load(f)


def sizes(spec: dict, cell: str) -> dict:
    """The test sizes of ``cell``: its kind's file and its reference's."""
    r = run.resolve(spec, cell)
    return {**load("kinds", r["traffic"]["kind"] + ".json"),
            **load("references", r["config"]["reference"] + ".json")}


def tiny_config(sizes: dict) -> dict:
    """The configuration overrides of the CPU runs."""
    return {"model": sizes["model"], "train": TRAIN}


class StepClock:
    """A clock that moves ``step`` seconds a reading."""

    def __init__(self, step: float):
        self.t, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def tiny_run(spec: dict, cell: str, sizes: dict, traced: bool = False,
             **kw) -> dict:
    """One 0.5-s run of ``cell`` at its tiny sizes on the CPU; the kind's
    window reads a clock moving ``clock_step`` s a reading where its file
    gives one. (The clip kind's 0.1 s makes the window serve 4 clips
    however slowly a loaded CPU runs them: its fault leaves each clip's
    last frame in place, and a window of one clip whose last frame is the
    one kept would compare no shifted frame.)"""
    args = (cell, SEED, 0.5, traced)
    kw = dict(device="cpu", spec=spec, config_overrides=tiny_config(sizes),
              traffic_overrides=sizes["tiny"], **kw)
    if sizes["clock_step"] is None:
        return run.run_cell(*args, **kw)
    kind = run.resolve(spec, cell)["kind"]
    clock = types.SimpleNamespace(
        perf_counter=StepClock(sizes["clock_step"]).perf_counter)
    with mock.patch.object(kind, "time", clock):
        return run.run_cell(*args, **kw)


def sound_run_is_correct(spec: dict, cell: str, sizes: dict) -> dict:
    """A sound tiny run is correct and reports every end-to-end metric
    that it can measure off the card; its result line ends in its
    checks."""
    out = tiny_run(spec, cell, sizes)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # a CPU run reads no device trace: its device metrics are not measured
    names = {m["name"] for m in run.resolve(spec, cell)["end_to_end"]
             if m["source"] != "device_trace"}
    assert set(out["metrics"]) == names
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    json.dumps(out)
    return out


def fault_is_caught(spec: dict, cell: str, sizes: dict, fault: str) -> dict:
    """A tiny run with ``fault`` planted under the timed path is not
    correct under the cell's own limits."""
    out = tiny_run(spec, cell, sizes, fault=fault)
    assert not out["correct"], out["checks"]
    return out


def traced_run_reports_device_window(spec: dict, cell: str, sizes: dict
                                     ) -> dict:
    """A traced tiny run is correct and reports its window, busy time and
    breakdown."""
    out = tiny_run(spec, cell, sizes, traced=True)
    assert out["correct"], out["checks"]
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    return out


def work_repeats_exactly(spec: dict, cell: str, sizes: dict) -> dict:
    """The operations and conv floor of one unit at the cell's own traffic
    and widths, twice: equal to the bit, and within the reference's
    ``unit_flops`` for the kind's unit where its file gives them."""
    r, rn = run.prepare(cell, 1, device="cpu", spec=spec)
    win = Window(1, 1.0, 1, 0, {})
    a = run.Traced(rn, r["kind"], win, EmptyProfile(), {}).work()
    b = run.Traced(rn, r["kind"], win, EmptyProfile(), {}).work()
    assert a == b
    assert a["flops"] > 0 and a["conv_floor_ms"] > 0
    bounds: Optional[list] = sizes.get("unit_flops", {}).get(sizes["unit"])
    if bounds is not None:
        assert bounds[0] < a["flops"] < bounds[1], a
    return a


def on_card_small(spec: dict, cell: str, sizes: dict) -> dict:
    """Full widths, the kind's ``card`` traffic and a 2-s traced window on
    the card: correct against the cell's limits, every per-layer metric
    read, and no share above 105 %."""
    out = run.run_cell(cell, SEED, 2.0, True, spec=spec,
                       traffic_overrides=sizes["card"])
    assert out["correct"], out["checks"]
    layer = {m["name"] for m in run.resolve(spec, cell)["per_layer"]}
    assert set(out["metrics"]) == layer
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105, name
    return out


def control_fails_on_card(spec: dict, cell: str, sizes: dict) -> None:
    """The control (the reference one precision below the configuration's
    in the port's place) at full width and the kind's ``control`` traffic,
    three seeds: never correct under the cell's limits."""
    for seed in (SEED, SEED + 1, SEED + 2):
        out = run.run_cell(cell, seed, 1.0, spec=spec, program="control",
                           traffic_overrides=sizes["control"])
        assert not out["correct"], (seed, out["checks"])


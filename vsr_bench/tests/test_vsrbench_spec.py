"""Every cell of BENCHMARK.json resolves, by name, to its configuration,
traffic, kind, limits and per-layer readers; the file keeps the contract's
shape."""

import importlib
import json
import os
import re

import pytest

from vsr_bench import run

SPEC = run.load_spec()
ALL = run.load_spec(later=True)       # with the cells kept for later
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cell_resolves(cell):
    r = run.resolve(ALL, cell)
    assert r["kind"].__name__ == "vsr_bench.kinds." + r["traffic"]["kind"]
    for fn in ("setup", "window", "release", "check", "work", "launches"):
        assert callable(getattr(r["kind"], fn))
    assert r["reference"].__name__ == ("vsr_bench.reference."
                                       + r["config"]["reference"])
    for fn in ("param_shapes", "forward", "Ops"):
        assert callable(getattr(r["reference"], fn))
    names = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert r["per_layer"]
    for m in r["per_layer"]:
        assert callable(run.load_metric(m["name"]))
        assert m["moves"] in names
    assert r["limits"] and all(v > 0 for v in r["limits"].values())
    assert set(r["config"]["reduced"]) <= set(r["config"]["vsr_config"]["model"])


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["vsr_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    seen = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("vsr_bench/") and os.path.exists(
            os.path.join(run.ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)
    everything = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
                  + SPEC["per_layer"])
    names = [x["name"] for x in everything]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_metric_files_are_all_named():
    """A reader for every per-layer metric and every end-to-end metric read
    from the device's trace, and no other."""
    named = {m["name"] for m in ALL["per_layer"]} | {
        m["name"] for m in ALL["end_to_end"] if m["source"] == "device_trace"}
    files = {f[:-3] for f in os.listdir(os.path.join(run.HERE, "metrics"))
             if f.endswith(".py")}
    assert named == files


def test_kinds_are_modules():
    for w in ALL["workloads"]:
        kind = run.resolve(ALL, w["name"])["traffic"]["kind"]
        importlib.import_module("vsr_bench.kinds." + kind)


def test_later_cells_use_their_own_names():
    """The cells kept for later share no name with the benchmark's, and
    each of their metrics names only them."""
    later = {w["name"] for w in ALL["workloads"]} - set(CELLS)
    assert later and not later & set(CELLS)
    names = [m["name"] for m in ALL["end_to_end"] + ALL["per_layer"]]
    assert len(set(names)) == len(names)
    for m in ALL["end_to_end"] + ALL["per_layer"]:
        if m not in SPEC["end_to_end"] + SPEC["per_layer"]:
            assert set(m["workloads"]) <= later

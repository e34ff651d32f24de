"""The harness end to end on the CPU at tiny sizes, its look for a card
skipped: a sound run is correct, and a run with its timed path broken
underneath is not, once for each fault the cell can have (a frame served
one frame late, a live frame's output stale, a train step that leaves its
state unchanged, a step on half its batch). The cells' own limits judge
them. On the card (``cuda`` marker): a run at full width on small frames,
and the control against the limits."""

import json

import pytest
import torch

from vsr_bench import run
from vsr_bench.tests.conftest import SMALL, TINY

SPEC = run.load_spec(later=True)
CELLS = {w["name"]: run.resolve(SPEC, w["name"])["traffic"]["kind"]
         for w in SPEC["workloads"]}
FAULTS = {"clip": ["shift"], "live": ["stale"],
          "train_step": ["unchanged", "half_batch"]}
SEED = 2 ** 31 + 11


def tiny_run(cell, traced=False, **kw):
    return run.run_cell(cell, SEED, 0.5, traced, device="cpu", spec=SPEC,
                        config_overrides=TINY,
                        traffic_overrides=SMALL[CELLS[cell]], **kw)


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", next(iter(CELLS)), "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell):
    out = tiny_run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in run.resolve(SPEC, cell)["end_to_end"]}
    assert set(out["metrics"]) == names
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    json.dumps(out)


@pytest.mark.parametrize("cell,fault", [(c, f) for c, k in CELLS.items()
                                        for f in FAULTS[k]])
def test_fault_is_caught(cell, fault):
    out = tiny_run(cell, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_traced_run_reports_device_window(cell):
    out = tiny_run(cell, traced=True)
    assert out["correct"]
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_on_card_small_frames(card, cell):
    """Full widths, small frames and short windows on the card: correct
    against the cells' limits, and every per-layer metric read."""
    small = {"clip": dict(lr_h=136, lr_w=240, clip_frames=[3, 6]),
             "live": dict(lr_h=136, lr_w=240, rate_fps=10),
             "train_step": dict(pool_batches=8)}[CELLS[cell]]
    out = run.run_cell(cell, SEED, 2.0, True, spec=SPEC,
                       traffic_overrides=small)
    assert out["correct"], out["checks"]
    layer = {m["name"] for m in run.resolve(SPEC, cell)["per_layer"]}
    assert set(out["metrics"]) == layer
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105, name


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_control_fails_on_card(card, cell):
    """The control, the reference at fp8 (the next precision below the
    configurations' bf16) in the port's place, at full width on small
    frames, three seeds: never correct under the cells' limits."""
    small = {"clip": dict(lr_h=136, lr_w=240, clip_frames=[3, 6]),
             "live": dict(lr_h=136, lr_w=240, rate_fps=10),
             "train_step": {}}[CELLS[cell]]
    for seed in (SEED, SEED + 1, SEED + 2):
        out = run.run_cell(cell, seed, 1.0, spec=SPEC, program="control",
                           traffic_overrides=small)
        assert not out["correct"], (seed, out["checks"])

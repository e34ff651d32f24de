"""The harness end to end on the CPU at tiny sizes, its look for a card
skipped: a sound run is correct, and a run with its timed path broken
underneath is not, once for each fault the cell can have (a frame served
one frame late, a live frame's output stale, a train step that leaves its
state unchanged, a step on half its batch). The cells' own limits judge
them. On the card (``cuda`` marker): a run at full width on small frames,
and the control against the limits."""

import json
import types
from unittest import mock

import pytest
import torch

from vsr_bench import run
from vsr_bench.kinds import clip
from vsr_bench.tests.conftest import SMALL, TINY

SPEC = run.load_spec(later=True)
CELLS = {w["name"]: run.resolve(SPEC, w["name"])["traffic"]["kind"]
         for w in SPEC["workloads"]}
FAULTS = {"clip": ["shift"], "live": ["stale"],
          "train_step": ["unchanged", "half_batch"]}
SEED = 2 ** 31 + 11


class StepClock:
    """A clock that moves ``step`` seconds a reading."""

    def __init__(self, step: float):
        self.t, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.t += self.step
        return self.t


def tiny_run(cell, traced=False, **kw):
    """One run at tiny sizes on the CPU. A clip cell's window reads a clock
    that moves 0.1 s a reading, so its 0.5 s serve 4 clips however slowly a
    loaded CPU runs them (a tiny clip takes ~0.1 s alone, seconds under four
    test workers): the shift fault leaves each clip's last frame in place,
    and this seed's first clip keeps its last frame, so a window of one clip
    would compare no shifted frame."""
    args = (cell, SEED, 0.5, traced)
    kw = dict(device="cpu", spec=SPEC, config_overrides=TINY,
              traffic_overrides=SMALL[CELLS[cell]], **kw)
    if CELLS[cell] != "clip":
        return run.run_cell(*args, **kw)
    clock = types.SimpleNamespace(perf_counter=StepClock(0.1).perf_counter)
    with mock.patch.object(clip, "time", clock):
        return run.run_cell(*args, **kw)


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
    # a CPU run reads no device trace: its device metrics are not measured
    names = {m["name"] for m in run.resolve(SPEC, cell)["end_to_end"]
             if m["source"] != "device_trace"}
    assert set(out["metrics"]) == names
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    json.dumps(out)


class KinetoEvent:
    """A raw profiler event as ``trace`` reads it, times in us."""

    def __init__(self, name, start, end, device=True):
        self._name, self._start, self._end = name, start, end
        self._type = (torch.autograd.DeviceType.CUDA if device
                      else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def correlation_id(self):
        return 0

    def start_ns(self):
        return int(self._start * 1e3)

    def end_ns(self):
        return int(self._end * 1e3)

    def is_user_annotation(self):
        return False


def test_device_only_window_lies_between_the_spins():
    """An untraced run of a cell with a device end-to-end metric records
    the device alone: no host range marks the window, so it is what ran
    between the spin kernels, and ``device_ms_per_frame`` is its busy time
    over the frames served."""
    cell = next(w["name"] for w in SPEC["workloads"] if any(
        m["source"] == "device_trace" and w["name"] in m["workloads"]
        for m in SPEC["end_to_end"]))
    r, cuda_run = run.prepare(cell, SEED, "cuda", SPEC, TINY,
                              SMALL[CELLS[cell]])
    events = [KinetoEvent("spin_kernel", 0, 250),
              KinetoEvent("conv3x3_kernel", 300, 400),
              KinetoEvent("conv3x3_kernel", 350, 500),
              KinetoEvent("Memcpy DtoH (Device -> Pinned)", 600, 650),
              KinetoEvent("cudaLaunchKernel", 290, 295, device=False),
              KinetoEvent("spin_kernel", 700, 950)]
    raw = types.SimpleNamespace(events=lambda: events, trace_start_ns=lambda: 0)
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=raw))
    win = run.Window(5, 1.0, 1, 0, {"serve_fps": 5.0})
    t = run.Traced(cuda_run, r["kind"], win, prof, {})
    assert (t.start, t.end) == (300.0, 650.0)
    assert t.busy_us() == pytest.approx(250.0)
    got = run.load_metric("device_ms_per_frame")(t)
    assert got == pytest.approx(250.0 / 1e3 / 5)


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

"""The harness end to end on the CPU at tiny sizes, its look for a card
skipped: a sound run is correct, and a run with its timed path broken
underneath is not, once for each fault the cell can have (a frame served
one frame late, a live frame's output stale, a train step that leaves its
state unchanged, a step on half its batch). The cells' own limits judge
them. On the card (``cuda`` marker): a run at full width on small frames,
and the control against the limits. Each cell's sizes and faults come
from its kind's and its reference's files under ``sizes/``, and each case
runs a body of ``bodies.py``."""

import types

import pytest
import torch

from vsr_bench import run
from vsr_bench.tests import bodies

SPEC = run.load_spec(later=True)
CELLS = [w["name"] for w in SPEC["workloads"]]
SIZES = {cell: bodies.sizes(SPEC, cell) for cell in CELLS}
SEED = bodies.SEED


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    bodies.sound_run_is_correct(SPEC, cell, SIZES[cell])


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
    r, cuda_run = run.prepare(cell, SEED, "cuda", SPEC,
                              bodies.tiny_config(SIZES[cell]),
                              SIZES[cell]["tiny"])
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


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in SIZES[c]["faults"]])
def test_fault_is_caught(cell, fault):
    bodies.fault_is_caught(SPEC, cell, SIZES[cell], fault)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_device_window(cell):
    bodies.traced_run_reports_device_window(SPEC, cell, SIZES[cell])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_card_small_frames(card, cell):
    """Full widths, small frames and short windows on the card: correct
    against the cells' limits, and every per-layer metric read."""
    bodies.on_card_small(SPEC, cell, SIZES[cell])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_card(card, cell):
    """The control, the reference at fp8 (the next precision below the
    configurations' bf16) in the port's place, at full width on small
    frames, three seeds: never correct under the cells' limits."""
    bodies.control_fails_on_card(SPEC, cell, SIZES[cell])

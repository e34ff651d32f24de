"""The readers of the serving entry's spans and counters
(``host_ms.*.serve``, ``idle_ms.entry.serve``, ``copy_back_gbps.serve``)
on hand-built traced windows whose host spans and device events overlap in
known ways, and on the tiny traced clip run on the CPU."""

import types

import pytest

from vsr_bench import idle_split, run, spans, trace
from vsr_bench.tests import bodies
from vsr_bench.trace import Event

HOST_MS = {"host_ms.forward.serve": "eval_step.forward",
           "host_ms.copy_back.serve": "upscale_clip.copy_back"}
DEVICE = ("idle_ms.entry.serve", "copy_back_gbps.serve")


def ev(name, start, end, cid=0):
    return Event(name, cid, float(start), float(end), False)


def traced(start, end, units, events=(), hosts=(), counters=None,
           on_card=True):
    """A ``run.Traced``-like window: device ``events`` and host spans
    ``hosts`` as (name, start, end), the entry's counters as
    (frames, bytes_back) on the kind's ``api.upscale_clip``."""
    entry = lambda: None  # noqa: E731  (a function, as the port's entry is)
    if counters is not None:
        entry.frames, entry.bytes_back = counters
    events = [ev(*e) for e in events]
    return types.SimpleNamespace(
        on_card=on_card, units=units, start=float(start), end=float(end),
        window_s=(end - start) / 1e6, events=events,
        busy_us=lambda: trace.union_us(events), hosts=[ev(*h) for h in hosts],
        kind=types.SimpleNamespace(api=types.SimpleNamespace(upscale_clip=entry)))


def kernel(s, e):
    return ("conv3x3_kernel", s, e)


IDLE_CASES = {
    # idle [100, 300]; the request's span covers its second half
    "gap_half_inside_a_span": (
        traced(0, 400, 1, [kernel(0, 100), kernel(300, 400)],
               [("upscale_clip", 200, 400)]), 0.1),
    # idle [100, 500] spans two requests and the harness between them
    "gap_spanning_two_spans": (
        traced(0, 600, 2, [kernel(0, 100), kernel(500, 600)],
               [("upscale_clip", 150, 250), ("upscale_clip", 300, 350)]),
        0.075),
    # overlapping spans count once; kernels inside a span are not idle;
    # the window's edges bound the gaps
    "overlaps_and_edges": (
        traced(0, 1000, 2, [kernel(100, 200), kernel(150, 260),
                            kernel(400, 500)],
               [("upscale_clip", 50, 300), ("upscale_clip", 250, 450),
                ("upscale_clip", 900, 1100),
                ("upscale_clip.stage", 0, 1000)]),
        (50 + 140 + 100) / 1e3 / 2),
    "no_spans": (traced(0, 400, 1, [kernel(0, 100)],
                        [("upscale_clip.stage", 0, 50)]), None),
    "off_card": (traced(0, 400, 1, [], [("upscale_clip", 0, 400)],
                        on_card=False), None),
}


@pytest.mark.parametrize("case", list(IDLE_CASES))
def test_idle_ms_entry(case):
    t, want = IDLE_CASES[case]
    got = run.load_metric("idle_ms.entry.serve")(t)
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("metric", list(HOST_MS))
def test_host_ms_sums_spans_cut_to_the_window(metric):
    name = HOST_MS[metric]
    t = traced(100, 1000, 4, [kernel(0, 1000)],
               [(name, 50, 150), (name, 300, 420), (name, 900, 1200),
                ("upscale_clip", 0, 1200), ("other", 200, 800)])
    assert run.load_metric(metric)(t) == pytest.approx((50 + 120 + 100) / 1e3 / 4)
    # a span wholly outside the window, or none: nothing to read
    t = traced(100, 1000, 4, [], [(name, 0, 100), ("upscale_clip", 100, 900)])
    assert run.load_metric(metric)(t) is None


COPIES = [kernel(0, 100), ("Memcpy DtoH (Device -> Pageable)", 100, 600),
          ("Memcpy DtoH (Device -> Pageable)", 700, 1200),
          ("Memcpy HtoD (Pageable -> Device)", 1200, 1900)]
GBPS_CASES = {
    # 1 MB a frame, 2 frames in the window, 1 ms of DtoH copies: 2 GB/s
    "rate": (traced(0, 2000, 2, COPIES, counters=(10, 10_000_000)), 2.0),
    "no_counters": (traced(0, 2000, 2, COPIES), None),
    "no_frames_counted": (traced(0, 2000, 2, COPIES, counters=(0, 0)), None),
    "no_copy_back": (traced(0, 2000, 2, COPIES[::3], counters=(10, 10)), None),
    "off_card": (traced(0, 2000, 2, COPIES, counters=(10, 10),
                        on_card=False), None),
}


@pytest.mark.parametrize("case", list(GBPS_CASES))
def test_copy_back_gbps(case):
    t, want = GBPS_CASES[case]
    got = run.load_metric("copy_back_gbps.serve")(t)
    assert got == pytest.approx(want) if want is not None else got is None


def test_interval_arithmetic():
    assert spans.merge([(5, 6), (0, 2), (1, 3), (3, 4), (7, 7)]) == [(0, 4), (5, 6)]
    assert spans.intersect([(0, 4), (5, 9)], [(1, 2), (3, 6), (8, 10)]) == [
        (1, 2), (3, 4), (5, 6), (8, 9)]
    t = traced(0, 10, 1, [kernel(2, 3), kernel(2.5, 4), kernel(9, 12)])
    assert spans.idle(t) == [(0, 2), (4, 9)]
    assert spans.idle(traced(0, 10, 1)) == [(0, 10)]


def test_tiny_traced_clip_run_reads_the_entry_spans():
    """On the CPU the entry's host spans are read; the device's idle time
    and copies are not there to read."""
    spec = run.load_spec()
    cell = "espcn.clip.540p"
    out = bodies.tiny_run(spec, cell, bodies.sizes(spec, cell), traced=True)
    assert out["correct"]
    for m in HOST_MS:
        assert out["metrics"][m]["value"] > 0 and out["metrics"][m]["unit"] == "ms/frame"
    assert not set(DEVICE) & set(out["metrics"])


def test_idle_split_names_every_idle_us():
    """``idle_split``'s split: the idle time under each inner range, the
    rest of the request's range, and the harness's, summing to the idle
    share of the window."""
    t = traced(0, 1000, 2, [kernel(100, 200), ("Memcpy DtoH", 600, 700)],
               [("upscale_clip", 0, 800), ("upscale_clip.gather", 0, 50),
                ("eval_step.upload", 50, 100), ("eval_step.forward", 100, 300),
                ("upscale_clip.stage", 300, 380),
                ("upscale_clip.copy_back", 380, 700)])
    got = idle_split.split_ms(t)
    want = {"upscale_clip.gather": 50, "eval_step.upload": 50,
            "eval_step.forward": 100, "upscale_clip.stage": 80,
            "upscale_clip.copy_back": 220, "upscale_clip.rest": 100,
            "harness": 200, "sum": 800, "idle_share_x_window": 800}
    assert got == pytest.approx({k: v / 1e3 / 2 for k, v in want.items()})


def test_idle_split_skew_pairs_launches_by_correlation_id():
    t = traced(0, 100, 1, [("k", 10, 20, 7), ("k", 30, 40, 8), ("k", 50, 60, 9)],
               [("cudaLaunchKernel", 12, 13, 7), ("cudaMemcpyAsync", 25, 26, 8),
                ("aten::add", 0, 90, 9)])
    got = idle_split.skew_us(t)
    assert got["matched"] == 2 and got["negative"] == 1
    assert got["min"] == -2 and got["median"] == 5

"""``recycled_share.serve``, the share of served frames written into
recycled clip memory, on hand-set counters of the kind's
``api.upscale_clip``."""

import types

import pytest

from vsr_bench import run


def traced(**counters):
    """A ``run.Traced``-like window whose kind's ``api.upscale_clip`` holds
    ``counters``."""
    entry = lambda: None  # noqa: E731  (a function, as the port's entry is)
    for k, v in counters.items():
        setattr(entry, k, v)
    return types.SimpleNamespace(
        on_card=True, units=4,
        kind=types.SimpleNamespace(api=types.SimpleNamespace(upscale_clip=entry)))


CASES = {
    "all_recycled": (dict(frames=40, frames_staged=40, frames_recycled=40), 100.0),
    "but_the_first_clip": (dict(frames=40, frames_staged=40, frames_recycled=37), 92.5),
    "none_recycled": (dict(frames=40, frames_staged=40, frames_recycled=0), 0.0),
    # the program keeps no such counter (the entry before recycling)
    "no_recycled_counter": (dict(frames=40, frames_staged=40), None),
    "no_frames_counted": (dict(frames=0, frames_recycled=0), None),
    "no_counters": ({}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_recycled_share(case):
    counters, want = CASES[case]
    got = run.load_metric("recycled_share.serve")(traced(**counters))
    assert got == pytest.approx(want) if want is not None else got is None


def test_no_entry_reads_nothing():
    t = types.SimpleNamespace(on_card=True, units=4, kind=types.SimpleNamespace())
    assert run.load_metric("recycled_share.serve")(t) is None

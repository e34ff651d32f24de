"""``graphed_share.serve``, the share of the served frames whose forward
replayed CUDA graphs, on hand-set counters of the kind's
``api.eval_step``."""

import types

import pytest

from vsr_bench import run


def traced(**counters):
    """A ``run.Traced``-like window whose kind's ``api.eval_step`` holds
    ``counters``."""
    step = lambda: None  # noqa: E731  (a function, as the port's entry is)
    for k, v in counters.items():
        setattr(step, k, v)
    return types.SimpleNamespace(
        on_card=True, units=4,
        kind=types.SimpleNamespace(api=types.SimpleNamespace(eval_step=step)))


CASES = {
    "all_replayed": (dict(calls=400, replays=400, captures=1), 100.0),
    "warm_calls_eager": (dict(calls=400, replays=399, captures=1), 99.75),
    "none_replayed": (dict(calls=40, replays=0, captures=0), 0.0),
    # the program keeps no such counter (the forward before CUDA graphs)
    "no_replay_counter": (dict(calls=40), None),
    "no_calls_counted": (dict(calls=0, replays=0), None),
    "no_counters": ({}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_share(case):
    counters, want = CASES[case]
    got = run.load_metric("graphed_share.serve")(traced(**counters))
    assert got == pytest.approx(want) if want is not None else got is None


def test_no_entry_reads_nothing():
    t = types.SimpleNamespace(on_card=True, units=4, kind=types.SimpleNamespace())
    assert run.load_metric("graphed_share.serve")(t) is None

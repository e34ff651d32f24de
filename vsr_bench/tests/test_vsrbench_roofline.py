"""The operation counts and the conv floors repeat exactly, and the frozen
arithmetic gives the datasheet's numbers."""

import pytest

from vsr_bench import roofline, run
from vsr_bench.cell import Window
from vsr_bench.tests.conftest import EmptyProfile

SPEC = run.load_spec(later=True)


def test_conv_floor_arithmetic():
    r = roofline.conv3x3_roofline_ms(1, 544, 960, 64, 64, 2)
    assert r["flops"] == 2 * 544 * 960 * 64 * 9 * 64
    assert r["bytes"] == (544 * 960 * 128 + 9 * 64 * 64) * 2 + 64 * 4
    assert r["floor_ms"] == max(r["flops"] / 989e12, r["bytes"] / 3.35e12) * 1e3
    r = roofline.conv3x3_roofline_ms(1, 544, 960, 256, 64, 2)
    assert r["bound_by"] == "operations"
    assert r["floor_ms"] == pytest.approx(r["flops"] / 989e12 * 1e3)
    w = roofline.warp_roofline_ms(2, 544, 960, 4, 2)
    assert w["bound_by"] == "bytes"
    c = roofline.correlation_roofline_ms(2, 136, 240, 32, 4, 2, 2)
    assert c["flops"] == 2 * 2 * 136 * 240 * 32 * 81


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_work_repeats_exactly(cell):
    """The per-unit operations and conv floor of each cell at its own
    shapes, twice: equal to the bit."""
    r, rn = run.prepare(cell, 1, device="cpu", spec=SPEC)
    kind = r["kind"]
    win = Window(1, 1.0, 1, 0, {})
    a = run.Traced(rn, kind, win, EmptyProfile(), {}).work()
    b = run.Traced(rn, kind, win, EmptyProfile(), {}).work()
    assert a == b
    assert a["flops"] > 0 and a["conv_floor_ms"] > 0
    if r["traffic"]["kind"] in ("clip", "live"):
        # one 540x960 -> 4K frame is ~2.2 TFLOP of convs
        assert 1.5e12 < a["flops"] < 5e12

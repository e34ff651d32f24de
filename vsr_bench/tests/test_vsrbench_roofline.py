"""The operation counts and the conv floors repeat exactly, and the frozen
arithmetic gives the datasheet's numbers."""

import pytest

from vsr_bench import roofline, run
from vsr_bench.tests import bodies

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


@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_floor_at_any_kernel_size(k):
    """A k x k conv reads a (Cout, Cin, k, k) weight and does 2 k^2 Cin
    FLOP an output element; the 3x3 floor is its k = 3 case to the bit."""
    b, h, w, cin, cout = 2, 68, 120, 32, 16
    r = roofline.conv_roofline_ms(b, h, w, cin, cout, k, 2, res_bytes=12)
    assert r["flops"] == 2 * b * h * w * cout * k * k * cin
    assert r["bytes"] == ((b * h * w * (cin + cout) + k * k * cin * cout) * 2
                          + cout * 4 + 12)
    assert r["floor_ms"] == max(r["flops"] / 989e12, r["bytes"] / 3.35e12) * 1e3
    if k == 3:
        assert r == roofline.conv3x3_roofline_ms(b, h, w, cin, cout, 2, 12)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_work_repeats_exactly(cell):
    """The per-unit operations and conv floor of each cell at its own
    shapes, twice: equal to the bit (a 540x960 -> 4K frame of the VSR
    model is ~2.2 TFLOP of convs)."""
    bodies.work_repeats_exactly(SPEC, cell, bodies.sizes(SPEC, cell))

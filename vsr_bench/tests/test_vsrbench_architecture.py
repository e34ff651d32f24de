"""A configuration names its plain reference, and the harness reaches the
reference through the run alone: a second architecture runs from new
files only (a reference module, a kind, a configuration, traffic, limits
and metric readers), and the VSR cells draw the same weights and read the
same work as when the harness imported ``reference/vsr.py`` itself."""

import json
import sys
import time
import types

import pytest
import torch
import torch.nn.functional as F

from vsr_bench import roofline, run, weights
from vsr_bench.cell import Window
from vsr_bench.reference import vsr
from vsr_bench.tests.conftest import EmptyProfile

SEED = 2 ** 31 + 23

# --- the toy architecture: a 3x3 conv, a LeakyReLU, a 3x3 conv to 3 s^2
# channels and a x s pixel shuffle; no parameter name is the VSR model's


class ToyOps:
    def __init__(self, quant=None, record=False):
        self.quant = quant
        self.convs = [] if record else None

    def q(self, x):
        return x if self.quant is None else x.to(self.quant).to(x.dtype)

    def conv(self, p, name, x, f32=False):
        w = p[name + ".weight"]
        y = F.conv2d(self.q(x), self.q(w), p[name + ".bias"], padding=1)
        if self.convs is not None:
            self.convs.append((y.shape[0], y.shape[2], y.shape[3],
                               w.shape[1], w.shape[0], f32))
        return y


def toy_param_shapes(m):
    c, s = m["channels"], m["scale"]
    return {"lift.weight": (c, 3, 3, 3), "lift.bias": (c,),
            "to_subpixels.weight": (3 * s * s, c, 3, 3),
            "to_subpixels.bias": (3 * s * s,)}


def toy_forward(p, m, x, ops=None):
    """x (B, H, W, 3) -> (B, s H, s W, 3)."""
    ops = ops or ToyOps()
    h = F.leaky_relu(ops.conv(p, "lift", x.permute(0, 3, 1, 2)), 0.1)
    y = F.pixel_shuffle(ops.conv(p, "to_subpixels", h), m["scale"])
    return y.permute(0, 2, 3, 1)


class ToyNet(torch.nn.Module):
    """The toy's program, apart from its reference."""

    def __init__(self, c, s):
        super().__init__()
        self.lift = torch.nn.Conv2d(3, c, 3, padding=1)
        self.to_subpixels = torch.nn.Conv2d(c, 3 * s * s, 3, padding=1)
        self.s = s

    def forward(self, x):
        h = F.leaky_relu(self.lift(x.permute(0, 3, 1, 2)), 0.1)
        return F.pixel_shuffle(self.to_subpixels(h), self.s).permute(0, 2, 3, 1)


def toy_kind(seen):
    """A kind serving batches of frames through ``ToyNet``; ``seen`` gets
    the run's weights."""

    def setup(r):
        seen["weights"] = r.weights
        net = ToyNet(r.model["channels"], r.model["scale"])
        weights.load(net, r.weights)
        gen = torch.Generator().manual_seed(r.seed % 2 ** 63)
        tr = r.traffic
        frames = torch.rand(tr["batch"], tr["h"], tr["w"], 3, generator=gen)
        return types.SimpleNamespace(run=r, net=net, frames=frames)

    def window(st, seconds):
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with torch.no_grad():
                out = st.net(st.frames)
            n += 1
        elapsed = time.perf_counter() - t0
        units = n * len(st.frames)
        return Window(units, elapsed, n, 0, {"toy_fps": units / elapsed},
                      {"out": out})

    def check(st, win):
        ref = st.run.reference.forward(st.run.weights, st.run.model, st.frames)
        d = float((win.extra["out"] - ref).abs().max())
        return {"out_max": {"value": d, "limit": st.run.limits["out_max"]}}

    def work(r):
        ref, tr = r.reference, r.traffic
        p = roofline.meta_params(ref.param_shapes(r.model))
        x = torch.empty(1, tr["h"], tr["w"], 3, device="meta")
        return lambda ops: ref.forward(p, r.model, x, ops)

    def release(st):
        st.net = None

    return types.SimpleNamespace(
        __name__="vsr_bench.kinds.toy_frames", setup=setup, window=window,
        check=check, work=work, release=release, launches=dict)


TOY_MODEL = {"channels": 8, "scale": 4}
TOY_TRAFFIC = {"kind": "toy_frames", "batch": 2, "h": 12, "w": 20}
TOY_SPEC = {
    "configs": [{"name": "toy", "source": "a test's own", "reduced": [],
                 "file": "vsr_bench/configs/toy.json", "why": "a test's own"}],
    "workloads": [{"name": "toy.frames", "config": "toy",
                   "traffic": "toy_frames", "chips": 1, "why": "a test's own"}],
    "end_to_end": [
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"},
        {"name": "toy_fps", "unit": "frames/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": ["toy.frames"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": "host_clock",
         "layer": "toy", "moves": "toy_fps", "workloads": ["toy.frames"]}
        for name, unit in (("toy_flops", "FLOP/frame"),
                           ("toy_conv_floor_ms", "ms/frame"))],
}
READERS = {"toy_flops": 'return float(t.work()["flops"])',
           "toy_conv_floor_ms": 'return t.work()["conv_floor_ms"]'}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's files in a checkout of their own, its reference and kind
    registered by name; what the toy's kind saw."""
    here = tmp_path / "vsr_bench"
    files = {"configs/toy.json": {"name": "toy", "reference": "toy_shuffle",
                                  "reduced": [], "vsr_config": {
                                      "model": TOY_MODEL,
                                      "train": {"compute_dtype": "float32"}}},
             "traffic/toy_frames.json": TOY_TRAFFIC,
             "limits/toy.frames.json": {"out_max": 1e-5}}
    for rel, d in files.items():
        (here / rel).parent.mkdir(parents=True, exist_ok=True)
        (here / rel).write_text(json.dumps(d))
    (here / "metrics").mkdir()
    for name, body in READERS.items():
        (here / "metrics" / (name + ".py")).write_text(
            f"def read(t):\n    {body}\n")
    reference = types.ModuleType("vsr_bench.reference.toy_shuffle")
    reference.param_shapes, reference.forward = toy_param_shapes, toy_forward
    reference.Ops = ToyOps
    seen = {}
    monkeypatch.setitem(sys.modules, reference.__name__, reference)
    monkeypatch.setitem(sys.modules, "vsr_bench.kinds.toy_frames",
                        toy_kind(seen))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    monkeypatch.setattr(run, "HERE", str(here))
    return seen


@pytest.mark.parametrize("traced", [False, True])
def test_second_architecture_from_new_files(toy, traced):
    out = run.run_cell("toy.frames", SEED, 0.3, traced, device="cpu",
                       spec=TOY_SPEC)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0
    shapes = toy_param_shapes(TOY_MODEL)
    want = weights.make(shapes, SEED, torch.device("cpu"))
    assert set(toy["weights"]) == set(shapes)
    assert all(torch.equal(toy["weights"][n], want[n]) for n in shapes)
    if not traced:
        assert set(out["metrics"]) == {"setup_s", "toy_fps"}
        return
    h, w, c, s = TOY_TRAFFIC["h"], TOY_TRAFFIC["w"], 8, 4
    convs = [(h, w, 3, c), (h, w, c, 3 * s * s)]
    assert out["metrics"]["toy_flops"]["value"] == sum(
        2 * hh * ww * cout * 9 * cin for hh, ww, cin, cout in convs)
    assert out["metrics"]["toy_conv_floor_ms"]["value"] == sum(
        roofline.conv3x3_roofline_ms(1, *shape, 4)["floor_ms"]
        for shape in convs)


def parent_work(rn):
    """``Traced.work()`` as the harness built it when it imported the VSR
    reference itself: the clip kind's forward of one frame, ``vsr.Ops``."""
    m, tr = rn.model, rn.traffic
    p = roofline.meta_params(vsr.param_shapes(m))
    x = torch.empty(1, m["window"], tr["lr_h"], tr["lr_w"], 3, device="meta")
    flops = roofline.flops(lambda: vsr.forward(p, m, x, vsr.Ops()))
    ops = vsr.Ops(record=True)
    vsr.forward(p, m, x, ops)
    compute = 2 if rn.train["compute_dtype"] in ("bfloat16", "float16") else 4
    floor = sum(roofline.conv3x3_roofline_ms(
        b, h, w, cin, cout, 4 if f32 else compute)["floor_ms"]
        for b, h, w, cin, cout, f32 in ops.convs)
    return {"flops": flops, "conv_floor_ms": floor}


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7, 2 ** 33 + 12345])
@pytest.mark.parametrize("cell", ["espcn.clip.540p", "two_stage_wf.clip.540p"])
def test_vsr_cells_draw_and_read_as_before(cell, seed):
    r, rn = run.prepare(cell, seed, device="cpu")
    assert rn.reference is vsr
    got = weights.for_run(rn)
    want = weights.make(vsr.param_shapes(rn.model), seed, rn.device)
    assert list(got) == list(want)
    assert all(torch.equal(got[n], want[n]) for n in want)
    traced = run.Traced(rn, r["kind"], Window(1, 1.0, 1, 0, {}),
                        EmptyProfile(), {})
    assert traced.work() == parent_work(rn)

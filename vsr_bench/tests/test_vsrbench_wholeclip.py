"""A recurrent whole-clip architecture and a traffic kind of a new name
enter the benchmark from new files alone, and run through the same test
bodies as the benchmark's cells (``bodies.py``): a reference that scales
its seeded draw (``init_scale``), records 7x7, 3x3 and 1x1 convs for the
floor, and a kind whose unit is a frame and whose check recomputes whole
clips. Its files live in a checkout of their own under a temporary
directory; nothing of the repository names it."""

import json
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vsr_bench import roofline, run, weights
from vsr_bench.cell import Window
from vsr_bench.tests import bodies

SEED = bodies.SEED          # the seed of the bodies' runs
REFERENCE = "toy_recurrent"
KIND = "toy_whole_clip"
CELL = "toy_recurrent.wholeclip"
TRUNKS = ("backward_trunk", "forward_trunk")
SLOPE = 0.1

# --- the toy architecture, after BasicVSR's shape: a hidden state carried
# backward over the whole clip, then forward; a 7x7 conv on each frame and
# its neighbour standing in for the flow; a lift and a residual block of
# 3x3 convs in each direction; a 1x1 fusion of the two states; a 3x3 conv
# to 3 s^2 channels and a x s pixel shuffle


class ToyOps:
    """The toy reference's convs, recorded as the contract says: a 3x3 conv
    without its kernel size, the others with it."""

    def __init__(self, quant=None, record=False):
        self.quant = quant
        self.convs = [] if record else None

    def q(self, x):
        return x if self.quant is None else x.to(self.quant).to(x.dtype)

    def conv(self, p, name, x, k):
        w = p[name + ".weight"]
        y = F.conv2d(self.q(x), self.q(w), p[name + ".bias"], padding=k // 2)
        if self.convs is not None:
            entry = (y.shape[0], y.shape[2], y.shape[3], w.shape[1],
                     w.shape[0], False)
            self.convs.append(entry if k == 3 else entry + (k,))
        return y


def toy_param_shapes(m):
    c, s = m["channels"], m["scale"]
    shapes = {"flow.weight": (2, 6, 7, 7), "flow.bias": (2,)}
    for t in TRUNKS:
        shapes.update({f"{t}.lift.weight": (c, 5 + c, 3, 3),
                       f"{t}.lift.bias": (c,)})
        for conv in ("conv1", "conv2"):
            shapes.update({f"{t}.res.{conv}.weight": (c, c, 3, 3),
                           f"{t}.res.{conv}.bias": (c,)})
    shapes.update({"fusion.weight": (c, 2 * c, 1, 1), "fusion.bias": (c,),
                   "upconv.weight": (3 * s * s, c, 3, 3),
                   "upconv.bias": (3 * s * s,)})
    return shapes


def toy_init_scale(m):
    """BasicSR's ``default_init_weights(..., 0.1)`` on the residual
    blocks' convs: their kernels' Kaiming draw times 0.1."""
    return {f"{t}.res.{conv}.weight": 0.1 for t in TRUNKS
            for conv in ("conv1", "conv2")}


def _trunk(p, ops, name, x, flow, h):
    y = F.leaky_relu(ops.conv(p, name + ".lift", torch.cat([x, flow, h], 1), 3),
                     SLOPE)
    r = ops.conv(p, name + ".res.conv1", y, 3)
    return y + ops.conv(p, name + ".res.conv2", F.relu(r), 3)


def toy_forward(p, m, x, ops=None):
    """A whole clip x (T, H, W, 3) -> (T, s H, s W, 3), frame by frame."""
    ops = ops or ToyOps()
    frames = x.permute(0, 3, 1, 2)
    t = frames.shape[0]
    h = frames.new_zeros(1, m["channels"], *frames.shape[2:])
    back = [None] * t
    for i in reversed(range(t)):
        xi, nb = frames[i:i + 1], frames[min(i + 1, t - 1)][None]
        h = _trunk(p, ops, "backward_trunk", xi,
                   ops.conv(p, "flow", torch.cat([xi, nb], 1), 7), h)
        back[i] = h
    h = torch.zeros_like(h)
    out = []
    for i in range(t):
        xi, nb = frames[i:i + 1], frames[max(i - 1, 0)][None]
        h = _trunk(p, ops, "forward_trunk", xi,
                   ops.conv(p, "flow", torch.cat([xi, nb], 1), 7), h)
        fused = F.leaky_relu(ops.conv(p, "fusion", torch.cat([back[i], h], 1),
                                      1), SLOPE)
        out.append(F.pixel_shuffle(ops.conv(p, "upconv", fused, 3), m["scale"]))
    return torch.cat(out).permute(0, 2, 3, 1)


class Trunk(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.lift = torch.nn.Conv2d(5 + c, c, 3, padding=1)
        self.res = torch.nn.Module()
        self.res.conv1 = torch.nn.Conv2d(c, c, 3, padding=1)
        self.res.conv2 = torch.nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x, flow, h):
        y = F.leaky_relu(self.lift(torch.cat([x, flow, h], 1)), SLOPE)
        return y + self.res.conv2(F.relu(self.res.conv1(y)))


class ToyNet(torch.nn.Module):
    """The toy's program, apart from its reference: each direction's flows
    in one batched conv. ``drop_backward`` plants the fault: the backward
    state is not carried from frame to frame."""

    def __init__(self, c, s):
        super().__init__()
        self.flow = torch.nn.Conv2d(6, 2, 7, padding=3)
        self.backward_trunk, self.forward_trunk = Trunk(c), Trunk(c)
        self.fusion = torch.nn.Conv2d(2 * c, c, 1)
        self.upconv = torch.nn.Conv2d(c, 3 * s * s, 3, padding=1)
        self.c, self.s = c, s

    def forward(self, clip, fault=None):
        x = clip.permute(0, 3, 1, 2)
        t = len(x)
        nxt = x[[min(i + 1, t - 1) for i in range(t)]]
        prv = x[[max(i - 1, 0) for i in range(t)]]
        f_back = self.flow(torch.cat([x, nxt], 1))
        f_fwd = self.flow(torch.cat([x, prv], 1))
        zero = x.new_zeros(1, self.c, *x.shape[2:])
        h, back = zero, [None] * t
        for i in reversed(range(t)):
            if fault == "drop_backward":
                h = zero
            h = self.backward_trunk(x[i:i + 1], f_back[i:i + 1], h)
            back[i] = h
        h, out = zero, []
        for i in range(t):
            h = self.forward_trunk(x[i:i + 1], f_fwd[i:i + 1], h)
            fused = F.leaky_relu(self.fusion(torch.cat([back[i], h], 1)), SLOPE)
            out.append(F.pixel_shuffle(self.upconv(fused), self.s))
        return torch.cat(out).permute(0, 2, 3, 1)


def toy_kind(seen):
    """Whole-clip serving through ``ToyNet``: a closed loop of one client,
    each request a clip of ``clip_frames`` frames from a seeded pool; a
    unit is a served frame. The check recomputes ``check_clips`` whole
    served clips, drawn from the seed, with the reference. ``seen`` gets
    the run's weights."""
    kind = types.ModuleType("vsr_bench.kinds." + KIND)
    kind.time = time

    def setup(r):
        seen["weights"] = r.weights
        net = ToyNet(r.model["channels"], r.model["scale"])
        weights.load(net, r.weights)
        tr = r.traffic
        gen = torch.Generator().manual_seed(r.seed % 2 ** 63)
        pool = torch.rand(tr["pool_clips"], tr["clip_frames"][1], tr["h"],
                          tr["w"], 3, generator=gen)
        return types.SimpleNamespace(run=r, net=net, pool=pool,
                                     rng=np.random.default_rng(r.seed % 2 ** 63))

    def window(st, seconds):
        lo, hi = st.run.traffic["clip_frames"]
        served, frames = [], 0
        t0 = kind.time.perf_counter()
        while kind.time.perf_counter() - t0 < seconds:
            k = int(st.rng.integers(len(st.pool)))
            length = int(st.rng.integers(lo, hi + 1))
            with torch.no_grad():
                out = st.net(st.pool[k, :length], st.run.fault)
            served.append((k, length, out))
            frames += length
        elapsed = kind.time.perf_counter() - t0
        return Window(frames, elapsed, len(served), 0,
                      {"toy_fps": frames / elapsed}, {"served": served})

    def check(st, win):
        r, served = st.run, win.extra["served"]
        n = min(r.traffic["check_clips"], len(served))
        gap = 0.0
        for i in st.rng.choice(len(served), n, replace=False):
            k, length, out = served[int(i)]
            with torch.no_grad():
                ref = r.reference.forward(r.weights, r.model,
                                          st.pool[k, :length])
            gap = max(gap, float((out - ref).abs().max()))
        return {"clip_max": {"value": gap, "limit": r.limits["clip_max"]}}

    def work(r):
        """One frame's step: the reference over a clip of one frame."""
        ref, tr = r.reference, r.traffic
        p = roofline.meta_params(ref.param_shapes(r.model))
        x = torch.empty(1, tr["h"], tr["w"], 3, device="meta")
        return lambda ops: ref.forward(p, r.model, x, ops)

    def release(st):
        st.net = None

    kind.setup, kind.window, kind.check = setup, window, check
    kind.work, kind.release, kind.launches = work, release, dict
    return kind


TOY_MODEL = {"channels": 8, "scale": 4}
TOY_TRAFFIC = {"kind": KIND, "h": 12, "w": 20, "clip_frames": [3, 5],
               "pool_clips": 3, "check_clips": 2}
TOY_SPEC = {
    "configs": [{"name": REFERENCE, "source": "a test's own", "reduced": [],
                 "file": f"vsr_bench/configs/{REFERENCE}.json",
                 "why": "a test's own"}],
    "workloads": [{"name": CELL, "config": REFERENCE, "traffic": KIND,
                   "chips": 1, "why": "a test's own"}],
    "end_to_end": [
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"},
        {"name": "toy_fps", "unit": "frames/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": [CELL]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": "host_clock",
         "layer": "toy", "moves": "toy_fps", "workloads": [CELL]}
        for name, unit in (("toy_flops", "FLOP/frame"),
                           ("toy_conv_floor_ms", "ms/frame"))],
}
READERS = {"toy_flops": 'return float(t.work()["flops"])',
           "toy_conv_floor_ms": 'return t.work()["conv_floor_ms"]'}
# the toy's test sizes, as a kind's and a reference's file would give them
TOY_SIZES = {"unit": "frame", "tiny": {}, "card": {}, "control": {},
             "faults": ["drop_backward"], "clock_step": None, "model": {}}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's files in a checkout of their own, its reference and kind
    registered by name; what the toy's kind saw."""
    here = tmp_path / "vsr_bench"
    files = {f"configs/{REFERENCE}.json": {
                 "name": REFERENCE, "reference": REFERENCE, "reduced": [],
                 "vsr_config": {"model": TOY_MODEL,
                                "train": {"compute_dtype": "float32"}}},
             f"traffic/{KIND}.json": TOY_TRAFFIC,
             f"limits/{CELL}.json": {"clip_max": 1e-5}}
    for rel, d in files.items():
        (here / rel).parent.mkdir(parents=True, exist_ok=True)
        (here / rel).write_text(json.dumps(d))
    (here / "metrics").mkdir()
    for name, body in READERS.items():
        (here / "metrics" / (name + ".py")).write_text(
            f"def read(t):\n    {body}\n")
    reference = types.ModuleType("vsr_bench.reference." + REFERENCE)
    reference.param_shapes, reference.forward = toy_param_shapes, toy_forward
    reference.Ops, reference.init_scale = ToyOps, toy_init_scale
    seen = {}
    monkeypatch.setitem(sys.modules, reference.__name__, reference)
    kind = toy_kind(seen)
    monkeypatch.setitem(sys.modules, kind.__name__, kind)
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    monkeypatch.setattr(run, "HERE", str(here))
    return seen


def hand_floor(h, w, c, s):
    """The least time of one frame's convs, f32, in the order the forward
    runs them: each direction's 7x7 flow, 3x3 lift and two 3x3 residual
    convs, then the 1x1 fusion and the 3x3 upconv."""
    convs = 2 * [(6, 2, 7), (5 + c, c, 3), (c, c, 3), (c, c, 3)] + [
        (2 * c, c, 1), (c, 3 * s * s, 3)]
    return sum(roofline.conv_roofline_ms(1, h, w, cin, cout, k, 4)["floor_ms"]
               for cin, cout, k in convs)


def test_sound_runs_read_the_hand_floor_and_the_scaled_draw(toy):
    bodies.sound_run_is_correct(TOY_SPEC, CELL, TOY_SIZES)
    shapes = toy_param_shapes(TOY_MODEL)
    want = weights.make(shapes, SEED, torch.device("cpu"))
    got = toy["weights"]
    assert list(got) == list(want)
    scaled = toy_init_scale(TOY_MODEL)
    for name in shapes:
        assert torch.equal(got[name], want[name] * scaled.get(name, 1.0)), name
    assert not torch.equal(got["forward_trunk.res.conv1.weight"],
                           want["forward_trunk.res.conv1.weight"])

    out = bodies.traced_run_reports_device_window(TOY_SPEC, CELL, TOY_SIZES)
    h, w = TOY_TRAFFIC["h"], TOY_TRAFFIC["w"]
    floor = hand_floor(h, w, TOY_MODEL["channels"], TOY_MODEL["scale"])
    assert out["metrics"]["toy_conv_floor_ms"]["value"] == floor
    assert out["metrics"]["toy_flops"]["value"] > 0


@pytest.mark.parametrize("fault", TOY_SIZES["faults"])
def test_fault_is_caught(toy, fault):
    bodies.fault_is_caught(TOY_SPEC, CELL, TOY_SIZES, fault)


def test_work_repeats_exactly(toy):
    work = bodies.work_repeats_exactly(TOY_SPEC, CELL, TOY_SIZES)
    h, w = TOY_TRAFFIC["h"], TOY_TRAFFIC["w"]
    assert work["conv_floor_ms"] == hand_floor(h, w, TOY_MODEL["channels"],
                                               TOY_MODEL["scale"])


def test_init_scale_names_only_parameters(toy):
    """A factor for a name ``param_shapes`` lacks is refused."""
    ref = sys.modules["vsr_bench.reference." + REFERENCE]
    _, rn = run.prepare(CELL, SEED, "cpu", TOY_SPEC)
    ref.init_scale = lambda m: {"no_such.weight": 0.1}
    with pytest.raises(ValueError, match="no_such.weight"):
        weights.for_run(rn)

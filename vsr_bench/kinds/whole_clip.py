"""Whole-clip serving of a recurrent model, what users of BasicSR's
``inference_basicvsr.py`` pay per chunk of a video: a closed loop of one
client, each request a clip of LR frames (f32 numpy in [0, 1] on the host)
through ``api.upscale_clip(model, frames)``, which uploads the clip once,
runs the model over all of it (flows both ways, the backward pass keeping
every state, then the forward pass) and copies each HR frame back as the
forward pass produces it. Frame c's output depends on every frame of the
clip.

Traffic parameters: ``lr_h``, ``lr_w`` (LR frame size), ``clip_frames``
([shortest, longest]: every seed gets each length in between, in its own
order; set-up serves one clip of the longest: every frame of every length
runs the same shapes, and only SPyNet's batch, twice the pairs, differs,
which a library picks its algorithm for on the host), ``pool_clips`` (the
content pool: moving, layered and zooming textures, made on the device),
``check_clips`` (the served clips the reference recomputes whole: a
reservoir of that many, drawn from the seed over the window's clips; of
each, its first and last frames, where one direction has no history, and
one frame drawn between them are kept, and the flows the clip's
propagation was given).

The kept frames go into host slots allocated and touched at set-up: the
window copies at most three frames a clip it draws, into pages already
faulted. The flows are taken as ``model.flows`` returns them to the timed
route (a reference, no copy) and held on the device for the kept clips
only: the seeded SPyNet's flows are sub-pixel, so zeroed flows move the
HR frames' RMS no more than the port's bf16 rounding does (PERF.md §2),
and the check reads the flows themselves. ``serve_fps``: every HR frame delivered to the host
over the window's whole time, for the host's share beside the device's.
``work`` is a frame's share of a long clip: SPyNet on one pair
each way, one step of each trunk and the upsampler (a clip of T frames
runs T - 1 pairs each way, so over the traffic's 8-24 frames the pairs a
frame are 255 / 272 of that, and the operations a frame ~0.6 % fewer).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import BasicVSRConfig
from vsr_bench import content, roofline, weights
from vsr_bench.cell import Window
from vsr_bench.kinds import _port

# the frames kept of a clip: first, last, and one drawn between
KEPT = 3


@dataclasses.dataclass
class State:
    run: object
    model: object
    pool: List[np.ndarray]
    rng: np.random.Generator
    lengths: List[int]
    slots: np.ndarray            # (check_clips, KEPT, sH, sW, 3), touched
    tap: "_FlowTap"
    detail: dict = dataclasses.field(default_factory=dict)


launches = _port.launches


class _DropState(torch.nn.Module):
    """The planted fault ``drop_backward``: a trunk that sees a zero state
    at every step, so the backward state is not carried from frame to
    frame (its input is ``[frame, state]``, BasicSR's order)."""

    def __init__(self, trunk: torch.nn.Module):
        super().__init__()
        self.trunk = trunk

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(torch.cat([x[..., :3], torch.zeros_like(x[..., 3:])],
                                    dim=-1))


def _zero_flows(flows):
    """The planted fault ``zero_flow``: SPyNet runs, but the propagation
    warps are given zero flows."""
    def zeroed(clip):
        return tuple(None if f is None else torch.zeros_like(f)
                     for f in flows(clip))
    return zeroed


class _FlowTap:
    """``model.flows`` with the flows of the last clip held, (backward,
    forward), each (T - 1, H, W, 2) f32 on the device, as the model
    returned them; the control sets ``last`` itself."""

    def __init__(self, flows=None):
        self.flows = flows
        self.last: Optional[tuple] = None

    def __call__(self, clip):
        self.last = self.flows(clip)
        return self.last


def serving_model(run):
    """``api.build_model`` of the cell's configuration with the benchmark's
    weights, the planted fault where the run has one."""
    cfg = BasicVSRConfig(compute_dtype=run.train["compute_dtype"], **run.model)
    model = api.build_model(cfg, run.device)
    weights.load(model, run.weights)
    if run.fault == "drop_backward":
        model.backward_trunk = _DropState(model.backward_trunk)
    if run.fault == "zero_flow":
        model.flows = _zero_flows(model.flows)
    return model


def setup(run) -> State:
    tr = run.traffic
    t = time.perf_counter()
    model = serving_model(run) if run.program == "port" else None
    run.phases["model"] = time.perf_counter() - t
    t = time.perf_counter()
    lo, hi = tr["clip_frames"]
    clips = content.clip_pool(tr["pool_clips"], hi, tr["lr_h"], tr["lr_w"],
                              run.seed, run.device)
    pool = [c.cpu().numpy() for c in clips]
    del clips
    s = run.reference.SCALE
    slots = np.empty((tr["check_clips"], KEPT, s * tr["lr_h"],
                      s * tr["lr_w"], 3), np.float32)
    slots.fill(0.0)                     # fault the pages in now
    run.phases["content"] = time.perf_counter() - t
    t = time.perf_counter()
    tap = _FlowTap()
    if model is not None:
        tap.flows, model.flows = model.flows, tap
    st = State(run, model, pool, np.random.default_rng(run.seed % 2 ** 63),
               list(range(lo, hi + 1)), slots, tap)
    if run.program == "port":       # the control has nothing to warm
        _upscale(st, pool[0][:hi])
        tap.last = None
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.phases["warm"] = time.perf_counter() - t
    return st


def _upscale(st: State, frames: np.ndarray) -> np.ndarray:
    run = st.run
    if run.program == "control":
        ref = run.reference
        ops = ref.Ops(quant=torch.float8_e4m3fn)
        with torch.no_grad():
            x = torch.as_tensor(frames).to(run.device)
            st.tap.last = _ref_flows(run, x, ops)
            out = ref.forward(run.weights, run.model, x, ops)
            return out.clamp(0.0, 1.0).cpu().numpy()
    return api.upscale_clip(st.model, frames)


def _ref_flows(run, clip: torch.Tensor, ops) -> tuple:
    """The reference's (backward, forward) flows of clip (T, H, W, 3), as
    ``model.flows`` gives them: each (T - 1, H, W, 2), TF32 off."""
    ref = run.reference
    if len(clip) < 2:
        return None, None
    f = clip.permute(0, 3, 1, 2)
    with ref.no_tf32():
        return tuple(ref.spynet(run.weights, ops, a, b).permute(0, 2, 3, 1)
                     for a, b in ((f[:-1], f[1:]), (f[1:], f[:-1])))


def window(st: State, seconds: float):
    order: List[int] = []
    kept = []           # (k, length, frame indices, flows), slot by slot
    frames = clips = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if not order:
            order = [int(x) for x in st.rng.permutation(st.lengths)]
        length = order.pop()
        k = int(st.rng.integers(len(st.pool)))
        out = _upscale(st, st.pool[k][:length])
        clips += 1
        # reservoir: each served clip ends up kept with the same chance
        slot = (clips - 1 if clips <= len(st.slots)
                else int(st.rng.integers(clips)))
        if slot < len(st.slots):
            idx = [0, length - 1, int(st.rng.integers(1, length - 1))]
            for j, i in enumerate(idx):
                np.copyto(st.slots[slot, j], out[i])
            entry = (k, length, idx, st.tap.last)
            if slot < len(kept):
                kept[slot] = entry
            else:
                kept.append(entry)
        st.tap.last = None
        del out
        frames += length
    elapsed = time.perf_counter() - t0
    return Window(frames, elapsed, clips, 0, {"serve_fps": frames / elapsed},
                  {"kept": kept})


def release(st: State) -> None:
    st.model = None


def check(st: State, win) -> dict:
    """Each kept clip recomputed whole by the reference (f32, TF32 off),
    clipped as the entry clips: the worst, over the kept frames, of the
    root mean square and of the largest absolute difference (``hr_rms``,
    ``hr_max``), and over the kept clips, of those of the flows the timed
    route was given against the reference's, in pixels (``flow_rms``,
    ``flow_max``; NaN, which fails, where the route took none), each beside
    its limit. ``detail`` has the HR gaps by frame position, the flow gaps
    by clip and the share of the flows' sample points that land inside
    the frame."""
    run = st.run
    ref = run.reference
    rms, top, flow_rms, flow_max = [], [], [], []
    by_pos = {"first": [], "last": [], "drawn": []}
    inside = []
    with torch.no_grad():
        for slot, (k, length, idx, flows) in enumerate(win.extra["kept"]):
            x = torch.as_tensor(st.pool[k][:length]).to(run.device)
            want = ref.forward(run.weights, run.model, x)[idx].clamp(0, 1)
            got = torch.as_tensor(st.slots[slot]).to(run.device)
            for pos, d in zip(by_pos, got - want):
                r, m = float(d.square().mean().sqrt()), float(d.abs().max())
                rms.append(r)
                top.append(m)
                by_pos[pos].append([r, m])
            del want, got
            ref_flows = torch.cat(_ref_flows(run, x, ref.Ops()))
            if flows is None or flows[0] is None:
                flow_rms.append(float("nan"))
                flow_max.append(float("nan"))
            else:
                d = torch.cat(flows).to(torch.float32) - ref_flows
                flow_rms.append(float(d.square().mean().sqrt()))
                flow_max.append(float(d.abs().max()))
                del d
            inside.append(_inside_share(ref_flows))
            del x, ref_flows
    st.detail = {"by_position": by_pos, "flow_by_clip": [
                     list(g) for g in zip(flow_rms, flow_max)],
                 "flow_inside_share": inside}
    nums = {"hr_rms": rms, "hr_max": top, "flow_rms": flow_rms,
            "flow_max": flow_max}
    # max() passes a NaN over unless it comes first: NaN must fail
    return {k: {"value": _worst(v), "limit": run.limits[k]}
            for k, v in nums.items()}


def _worst(values: List[float]) -> float:
    """The largest of ``values``; NaN where there are none or any is
    NaN."""
    if not values or any(v != v for v in values):
        return float("nan")
    return max(values)


def _inside_share(flows: torch.Tensor) -> float:
    """Share of the propagation warps' sample points, ``flows`` (N, H, W,
    2) of both directions, that land inside the frame."""
    _, h, w, _ = flows.shape
    xs = torch.arange(w, device=flows.device) + flows[..., 0]
    ys = torch.arange(h, device=flows.device)[:, None] + flows[..., 1]
    inside = (xs >= 0) & (xs <= w - 1) & (ys >= 0) & (ys <= h - 1)
    return float(inside.float().mean())


def work(run):
    """A frame's share of a long clip at the cell's shapes, on the meta
    device: SPyNet on one pair each way, a step of each trunk (with its
    warp) and the upsampler."""
    tr, ref = run.traffic, run.reference
    p = roofline.meta_params(ref.param_shapes(run.model))
    pair = torch.empty(2, 3, tr["lr_h"], tr["lr_w"], device="meta")
    state = torch.empty(1, run.model["num_feat"], tr["lr_h"], tr["lr_w"],
                        device="meta")

    def unit(ops):
        flows = ref.spynet(p, ops, pair, pair.flip(0))
        back = ref.step(p, run.model, ops, "backward_trunk", pair[:1], state,
                        flows[:1])
        fwd = ref.step(p, run.model, ops, "forward_trunk", pair[:1], state,
                       flows[1:])
        return ref.upsample(p, ops, pair[:1], back, fwd)
    return unit

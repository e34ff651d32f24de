"""Clip serving, what ``cli infer`` users pay per clip: a closed loop of
one client, each request a clip of LR frames (f32 numpy in [0, 1] on the
host) through ``api.upscale_clip(model, frames, "replicate")``, which
uploads each frame's window, runs ``eval_step`` and copies the HR frame
back, then stacks the clip.

Traffic parameters: ``lr_h``, ``lr_w`` (LR frame size), ``clip_frames``
([shortest, longest]: every seed gets each length in between, in its own
order), ``pool_clips`` (the content pool: moving, layered and zooming
textures, made on the device), ``warm_clips`` and ``warm_frames`` (set-up
requests at the timed shapes), ``check_frames`` (the served frames the
reference recomputes: one frame is kept from each clip, the clip's first
or last in half of them, and these many are drawn from the kept ones).

``serve_fps``: every HR frame delivered to the host over the window's
whole time; the window closes when the last clip started inside it
returns.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from vsr_bench import content
from vsr_bench.cell import Window
from vsr_bench.kinds import _port
from vsr_bench.reference.vsr import window_indices


@dataclasses.dataclass
class State:
    run: object
    model: object
    pool: List[np.ndarray]
    rng: np.random.Generator
    lengths: List[int]


launches = _port.launches


def setup(run) -> State:
    tr = run.traffic
    t = time.perf_counter()
    model = _port.serving_model(run) if run.program == "port" else None
    run.phases["model"] = time.perf_counter() - t
    t = time.perf_counter()
    clips = content.clip_pool(tr["pool_clips"], tr["clip_frames"][1],
                              tr["lr_h"], tr["lr_w"], run.seed, run.device)
    pool = [c.cpu().numpy() for c in clips]
    del clips
    run.phases["content"] = time.perf_counter() - t
    t = time.perf_counter()
    lo, hi = tr["clip_frames"]
    st = State(run, model, pool, np.random.default_rng(run.seed % 2 ** 63),
               list(range(lo, hi + 1)))
    for _ in range(tr["warm_clips"]):
        _upscale(st, pool[0][:tr["warm_frames"]])
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.phases["warm"] = time.perf_counter() - t
    return st


def _upscale(st: State, frames: np.ndarray) -> np.ndarray:
    run = st.run
    if run.program == "control":
        t = len(frames)
        return np.stack([_port.control_upscale(run, frames[
            window_indices(t, c, run.model["window"])][None])
            for c in range(t)])
    out = api.upscale_clip(st.model, frames, "replicate")
    if run.fault == "shift":          # each frame served one frame late
        out = np.concatenate([out[1:], out[-1:]])
    return out


def window(st: State, seconds: float):
    order = []
    kept = []
    frames = clips = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if not order:
            order = [int(x) for x in st.rng.permutation(st.lengths)]
        length = order.pop()
        k = int(st.rng.integers(len(st.pool)))
        c = int(st.rng.choice([0, length - 1, int(st.rng.integers(length))],
                              p=[0.25, 0.25, 0.5]))
        out = _upscale(st, st.pool[k][:length])
        kept.append((k, length, c, out[c].copy()))
        del out
        frames += length
        clips += 1
    elapsed = time.perf_counter() - t0
    return Window(frames, elapsed, clips, 0, {"serve_fps": frames / elapsed},
                  {"kept": kept})


def release(st: State) -> None:
    st.model = None


def check(st: State, win) -> dict:
    run = st.run
    kept = win.extra["kept"]
    n = min(run.traffic["check_frames"], len(kept))
    pick = sorted(int(i) for i in st.rng.choice(len(kept), n, replace=False))
    served, windows = [], []
    for i in pick:
        k, length, c, hr = kept[i]
        served.append(hr)
        windows.append(st.pool[k][window_indices(
            length, c, run.model["window"])][None])
    return _port.compare_frames(run, served, windows, run.limits)


def work(run):
    """One frame's forward at the cell's shapes, on the meta device."""
    from vsr_bench import roofline

    tr, ref = run.traffic, run.reference
    p = roofline.meta_params(ref.param_shapes(run.model))
    x = torch.empty(1, run.model["window"], tr["lr_h"], tr["lr_w"], 3,
                    device="meta")
    return lambda ops: ref.forward(p, run.model, x, ops)

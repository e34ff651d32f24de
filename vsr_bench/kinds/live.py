"""Live upscaling of one stream, what users of streams and calls feel: an
open loop, LR frames arriving at a fixed rate. Frame c is produced once
frame c + 1 has arrived: one ``api.eval_step(model, window)`` on the last
``window`` frames (the first frame replicated at the stream's start),
then ``.cpu()``: the per-frame body of ``api.upscale_clip``.

Traffic parameters: ``lr_h``, ``lr_w``, ``rate_fps`` (the arrival rate),
``pool_clips`` and ``clip_frames`` (the content: the stream runs forward
and back through one clip of the pool, the seed's), ``warm_frames``
(set-up frames at the timed shape), ``check_frames`` (served frames the
reference recomputes, drawn from the seed, the stream's first among
them).

``frame_ms_p95``: the 95th percentile, over every frame due inside the
window, of the time from when the frame that completes its window arrived
to when its HR frame is on the host. Frames that fall behind are served
late, in order, and their wait counts.
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

launches = _port.launches


@dataclasses.dataclass
class State:
    run: object
    model: object
    frames: torch.Tensor          # the stream's clip, host f32 (T, h, w, 3)
    rng: np.random.Generator


def _stream_index(i: int, t: int) -> int:
    """Frame i of a stream that runs forward and back through t frames."""
    period = 2 * (t - 1)
    pos = i % period
    return pos if pos < t else period - pos


def _window_of(st: State, c: int) -> List[int]:
    r = st.run.model["window"] // 2
    t = st.frames.shape[0]
    return [_stream_index(max(i, 0), t) for i in range(c - r, c + r + 1)]


def setup(run) -> State:
    tr = run.traffic
    t = time.perf_counter()
    model = _port.serving_model(run) if run.program == "port" else None
    run.phases["model"] = time.perf_counter() - t
    t = time.perf_counter()
    clips = content.clip_pool(tr["pool_clips"], tr["clip_frames"], tr["lr_h"],
                              tr["lr_w"], run.seed, run.device)
    pick = run.seed % len(clips)
    frames = torch.from_numpy(clips[pick].cpu().numpy())
    del clips
    run.phases["content"] = time.perf_counter() - t
    t = time.perf_counter()
    st = State(run, model, frames, np.random.default_rng(run.seed % 2 ** 63))
    for c in range(tr["warm_frames"]):
        _serve(st, c)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.phases["warm"] = time.perf_counter() - t
    return st


def _serve(st: State, c: int) -> np.ndarray:
    window = st.frames[_window_of(st, c)][None]
    if st.run.program == "control":
        return _port.control_upscale(st.run, window.numpy())
    return api.eval_step(st.model, window)[0].cpu().numpy()


def window(st: State, seconds: float) -> Window:
    rate = float(st.run.traffic["rate_fps"])
    n = max(1, int(np.ceil(rate * seconds)) - 1)   # due inside the window
    keep = {0} | {int(i) for i in st.rng.choice(
        np.arange(1, max(n, 2)), min(st.run.traffic["check_frames"],
                                      max(n - 1, 1)), replace=False)}
    lat, kept, prev = [], {}, None
    t0 = time.perf_counter()
    for c in range(n):
        due = t0 + (c + 1) / rate
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        out = _serve(st, c)
        lat.append(time.perf_counter() - due)
        if st.run.fault == "stale" and prev is not None:
            out, prev = prev, out             # the previous frame's output
        else:
            prev = out
        if c in keep:
            kept[c] = out.copy()
    elapsed = time.perf_counter() - t0
    ms = np.asarray(lat) * 1e3
    return Window(n, elapsed, n, 0,
                  {"frame_ms_p95": float(np.percentile(ms, 95))},
                  {"kept": kept, "latency_ms": ms})


def release(st: State) -> None:
    st.model = None


def check(st: State, win: Window) -> dict:
    kept = win.extra["kept"]
    served = [kept[c] for c in sorted(kept)]
    windows = [st.frames[_window_of(st, c)][None].numpy() for c in sorted(kept)]
    return _port.compare_frames(st.run, served, windows, st.run.limits)


def work(run):
    """One frame's forward at the cell's shapes, on the meta device."""
    from vsr_bench import roofline

    tr, ref = run.traffic, run.reference
    p = roofline.meta_params(ref.param_shapes(run.model))
    x = torch.empty(1, run.model["window"], tr["lr_h"], tr["lr_w"], 3,
                    device="meta")
    return lambda ops: ref.forward(p, run.model, x, ops)

"""Training, what a job's time is made of: the train step users train
with (``training/step.py:make_train_step``: forward, Charbonnier loss,
backward, global-norm clip, Adam with its schedule) on
``training.create_train_state``, fed through
``training/loop.py:device_prefetch`` as the train loop feeds it.

Traffic parameters: ``batch``, ``crop`` (LR crop; HR is ``scale`` times
it), ``pool_batches`` (distinct batches made from the seed, cycled),
``source_clips`` and ``source_hw`` (the synthetic HR clips the crops come
from, made on the device; LR by the benchmark's copy of the bicubic
degradation), ``checked_steps`` (the first steps, which set-up runs
through the window's own call and feed and the reference follows).

``train_steps_per_s``: every step of the window over its whole time, the
last ended on the device.

The check: each checked step's loss, the norm of the first step's
gradient as Adam received it (read from its first moment), and the norm
of each parameter's change over the checked steps (read before the next
step), all against the reference from the same weights and batches. A
leaf's gap is against the larger of its reference norm and the median
leaf's. The loss is judged by its worst step; the gradient and the change
by the median leaf's gap: the worst leaf's swings from seed to seed with
the depth branch's last convs, whose gradient passes through the fusion's
|depth difference| where that difference is 0 but for rounding (PERF.md).
The worst leaves are printed beside the check. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out of the change.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from video_super_resolution_tpu_torch.training import create_train_state
from video_super_resolution_tpu_torch.training.loop import device_prefetch
from video_super_resolution_tpu_torch.training.step import make_train_step
from vsr_bench import content, weights
from vsr_bench.cell import Window
from vsr_bench.kinds import _port
from vsr_bench.reference import train as reftrain

launches = _port.launches
NEGLIGIBLE = 1e-3          # of the median leaf's reference gradient


@dataclasses.dataclass
class State:
    run: object
    state: object
    step: object
    feed: object
    pool: List[dict]
    observed: dict


def make_pool(run) -> List[dict]:
    """``pool_batches`` distinct batches of host f32 numpy: {"lr": (B, T,
    crop, crop, 3), "hr": (B, s crop, s crop, 3)}, HR crops at seeded
    places of seeded synthetic clips, LR their bicubic degradation."""
    tr, m = run.traffic, run.model
    s, t, b = m["scale"], m["window"], tr["batch"]
    hc = tr["crop"] * s
    h, w = tr["source_hw"]
    clips = content.clip_pool(tr["source_clips"], t, h, w, run.seed + 1,
                              run.device)
    rng = np.random.default_rng(run.seed % 2 ** 63)
    n = tr["pool_batches"] * b
    src = rng.integers(len(clips), size=n)
    ys = rng.integers(0, h - hc + 1, size=n)
    xs = rng.integers(0, w - hc + 1, size=n)
    hr = torch.stack([clips[k][:, y:y + hc, x:x + hc]
                      for k, y, x in zip(src, ys, xs)])    # (n, T, hc, hc, 3)
    lr = content.degrade(hr, s)
    hr = hr[:, t // 2].cpu().numpy()
    lr = lr.cpu().numpy()
    return [{"lr": lr[i:i + b], "hr": hr[i:i + b]} for i in range(0, n, b)]


def _faulty(step, fault):
    """The step with a planted fault (harness tests only)."""
    if fault == "unchanged":            # the state comes back as it went in
        def unchanged(state, batch):
            params = list(state.model.parameters())
            saved = [p.detach().clone() for p in params]
            state, metrics = step(state, batch)
            with torch.no_grad():
                torch._foreach_copy_(params, saved)
            state.optimizer.state.clear()
            state.step -= 1
            return state, metrics
        return unchanged
    if fault == "half_batch":           # half the batch left out
        def half(state, batch):
            k = len(batch["lr"]) // 2
            return step(state, {key: v[:k] for key, v in batch.items()})
        return half
    return step


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack(torch._foreach_norm([tensors[n].float() for n in names]))
    return dict(zip(names, vals.tolist()))


def setup(run) -> State:
    t = time.perf_counter()
    pool = make_pool(run)
    run.phases["content"] = time.perf_counter() - t
    if run.program == "control":
        # the reference at fp8 in the program's place, over the checked steps
        observed = reference_steps(
            run, pool, run.reference.Ops(quant=torch.float8_e4m3fn))
        return State(run, None, None, None, pool, observed)
    t = time.perf_counter()
    cfg = _port.vsr_config(run)
    state = create_train_state(cfg, run.device)
    weights.load(state.model, run.weights)
    step = _faulty(make_train_step(cfg.train.charbonnier_eps), run.fault)
    feed = device_prefetch(itertools.cycle(pool), run.device)
    run.phases["model"] = time.perf_counter() - t
    t = time.perf_counter()
    params = dict(state.model.named_parameters())
    b1 = run.train["adam_b1"]
    losses, grad = [], None
    for i in range(run.traffic["checked_steps"]):
        state, metrics = step(state, next(feed))
        losses.append(metrics["loss"])
        if i == 0:
            opt = state.optimizer.state
            grad = {n: opt[p]["exp_avg"] / (1 - b1) if p in opt
                    else torch.zeros_like(p) for n, p in params.items()}
            grad = _norms(grad)
    change = _norms({n: p.detach() - run.weights[n] for n, p in params.items()})
    observed = {"losses": [float(x) for x in losses], "grad": grad,
                "change": change}
    run.phases["checked_steps"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(run.traffic.get("warm_steps", 0)):
        state, _ = step(state, next(feed))
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.phases["warm"] = time.perf_counter() - t
    return State(run, state, step, feed, pool, observed)


def window(st: State, seconds: float) -> Window:
    if st.run.program == "control":
        return Window(1, 1.0, 1, 0, {"train_steps_per_s": 0.0})
    steps = 0
    state = st.state
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        state, _ = st.step(state, next(st.feed))
        steps += 1
    if st.run.device.type == "cuda":
        torch.cuda.synchronize(st.run.device)
    elapsed = time.perf_counter() - t0
    return Window(steps, elapsed, steps, 0,
                  {"train_steps_per_s": steps / elapsed})


def release(st: State) -> None:
    st.state = st.step = st.feed = None


def reference_steps(run, pool, ops=None) -> dict:
    """The reference's readings over the checked steps, as ``observed``."""
    _port.no_tf32()
    batches = [{k: torch.as_tensor(v).to(run.device) for k, v in b.items()}
               for b in pool[:run.traffic["checked_steps"]]]
    r = reftrain.steps(run.reference.forward, run.weights, run.model,
                       run.train, batches, ops)
    return {"losses": r["losses"], "grad": _norms(r["first_grad"]),
            "change": _norms(r["change"])}


def gaps(observed: dict, ref: dict) -> Tuple[Dict[str, float], dict]:
    """The loss gap (worst step, relative) and the median leaf's gap of the
    first gradient's norm and of the change's norm; beside them the worst
    leaf's gaps and the five worst leaves of each, as [name, program,
    reference, gap]."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(observed["losses"],
                                                    ref["losses"]))
    g_med = float(np.median(list(ref["grad"].values())))
    grad = {n: abs(observed["grad"][n] - g) / max(g, g_med)
            for n, g in ref["grad"].items()}
    moved = [n for n, g in ref["grad"].items() if g >= NEGLIGIBLE * g_med]
    c_med = float(np.median([ref["change"][n] for n in moved]))
    change = {n: abs(observed["change"][n] - ref["change"][n])
              / max(ref["change"][n], c_med) for n in moved}
    detail = {k: [[n, observed[k][n], ref[k][n], v] for n, v in
                  sorted(d.items(), key=lambda kv: -kv[1])[:5]]
              for k, d in (("grad", grad), ("change", change))}
    detail["worst_gap"] = {"grad": max(grad.values()),
                           "change": max(change.values())}
    detail["left_out"] = sorted(set(ref["grad"]) - set(moved))
    return ({"loss": loss,
             "grad_median": float(np.median(list(grad.values()))),
             "change_median": float(np.median(list(change.values())))},
            detail)


def check(st: State, win: Window) -> dict:
    run = st.run
    nums, st.detail = gaps(st.observed, reference_steps(run, st.pool))
    for k in ("grad", "change"):
        worst = ", ".join(f"{n} {p:.4g}/{r:.4g}"
                          for n, p, r, _ in st.detail[k][:3])
        print(f"worst {k} leaves (program/reference): {worst}",
              file=sys.stderr)
    return {k: {"value": v, "limit": run.limits[k]} for k, v in nums.items()}


def work(run):
    """One step's forward and backward at the cell's shapes, on the meta
    device."""
    from vsr_bench import roofline

    tr, m, ref = run.traffic, run.model, run.reference
    p = roofline.meta_params(ref.param_shapes(m), grad=True)
    c = tr["crop"]
    x = torch.empty(tr["batch"], m["window"], c, c, 3, device="meta")
    y = torch.empty(tr["batch"], c * m["scale"], c * m["scale"], 3,
                    device="meta")

    def step(ops):
        loss = reftrain.charbonnier(ref.forward(p, m, x, ops), y,
                                    run.train["charbonnier_eps"])
        return torch.autograd.grad(loss, list(p.values()))
    return step

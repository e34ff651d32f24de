"""The train step's time split into device compute, per-step dispatch,
input transfer and K-step amortisation: the port's counterpart of the JAX
package's ``tools/bench_dispatch.py``.

    python -m video_super_resolution_tpu_torch.tools.bench_dispatch \\
        [--steps 600 --k 16] [--root DIR] [--out FILE] [--device cpu]

``VSRConfig()`` (batch 4, LR crop 64, window 3, bf16) with seeded random
weights, one process, the same train step in every control, in the JAX
tool's order, each with its warm-up (the JAX tool's counts, ``WARM``;
``run``'s caller may set fewer) and one sync at the end of its loop
(``loss.item()``):

1. ``device_side_steps_per_s``: ``--steps`` steps on a constant batch
   (numpy's ``default_rng(0)``, staged on the device) under
   ``torch.profiler``, N over the device's busy seconds: the union of its
   kernels' and copies' intervals (one stream), traced PROFILE_CHUNK steps
   at a time; a trace that lacks a counted launch of the port's kernels
   is taken again (``profile_prefix.profiled``). JAX chained the N steps in one ``lax.scan`` program; the
   port has no such program (capturing the step in a CUDA graph is later
   ``perf_opt`` work), so ``device_side_method`` is "profiled busy" and
   ``first_call_s`` (the first step, the kernels' build included) takes
   the place of ``compile_device_side_s``. On the CPU (``--device cpu``)
   the "device" is the host: the union of the top-level ops' intervals.
2. ``dispatch_only_steps_per_s``: a Python loop of single steps on the
   pre-staged constant batch, after 20 warm steps: no loader, no transfer.
3. ``host_driven_k1_steps_per_s``: the production stream on PNG clips
   (``bench_loader.make_png_clips``): ``training.loop.make_batch_stream``
   (``loader``: "native" or "python") and ``device_prefetch``, after 40
   warm steps.
4. ``host_driven_k1_compact_steps_per_s``: the same stream through
   ``compact_batches`` (uint8 HR, bf16 LR), after 20 warm steps.
5. ``host_driven_k{K}_steps_per_s``: K stream batches stacked with numpy,
   moved to the device, and ``make_multi_train_step`` over ``steps // k``
   calls. The port's multi-step is a Python loop of K steps
   (``training/step.py:make_multi_train_step``), so it amortises no
   launches: this control measures that as it is.

Then each control over the device-side bound (``ratio_*``) and the
verdict, JAX's rule: launch-bound when ``|dispatch_only - k1| < 0.35 max``.
The state is updated in place, so each control continues from the last
(JAX restarted each from the initial state; the work a step is the same).
``device``: the card's ``nvidia-smi`` name and power limit, or "cpu".
Writes ``artifacts/BENCH_dispatch_torch.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import tempfile
import time
from typing import Callable, ContextManager, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.data.dataset import ClipDataset
from video_super_resolution_tpu_torch.tools import profile_prefix as pp
from video_super_resolution_tpu_torch.training.loop import (
    compact_batches,
    device_prefetch,
    make_batch_stream,
)
from video_super_resolution_tpu_torch.training.state import TrainState, create_train_state
from video_super_resolution_tpu_torch.training.step import (
    Step,
    make_multi_train_step,
    make_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "vsr_loader_bench")
PROFILE_CHUNK = 50      # steps a torch.profiler trace (bounds its buffers)
LAUNCH_BOUND = 0.35     # JAX's rule: |dispatch_only - k1| < 0.35 max
# warm steps before each Python-loop control: the JAX tool's counts
WARM = {"dispatch_only": 20, "host_driven_k1": 40, "host_driven_k1_compact": 20}
Around = Callable[[str], ContextManager]


def device_record(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    from video_super_resolution_tpu_torch.tools.quality_serving import device_label

    return device_label(dev)


def write_record(out: Optional[str], rec: dict) -> None:
    """``rec`` as indented JSON at ``out`` (its directory made), if given."""
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def constant_batch(cfg: VSRConfig, dev: torch.device) -> Dict[str, torch.Tensor]:
    """The JAX tool's constant batch (``default_rng(0)``), f32 on ``dev``."""
    b, t, c = cfg.data.batch_size, cfg.model.window, cfg.data.crop_size
    rng = np.random.default_rng(0)
    lr = rng.random((b, t, c, c, 3))
    hr = rng.random((b, 4 * c, 4 * c, 3))
    return {"lr": torch.from_numpy(lr).to(dev, torch.float32),
            "hr": torch.from_numpy(hr).to(dev, torch.float32)}


def union_us(events) -> float:
    """Length of the union of the profiler events' time ranges (us)."""
    total, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def profiled_busy(fn: Callable[[], object], n: int, dev: torch.device
                  ) -> Tuple[float, int]:
    """n calls of fn under torch.profiler (``profile_prefix.profiled``:
    each trace holds every counted launch of the port's kernels),
    PROFILE_CHUNK calls a trace: the busy seconds (the union of the
    device's kernels and copies, or on the CPU of the top-level ops) and
    the number of those events."""
    busy, events, done = 0.0, 0, 0
    while done < n:
        m = min(PROFILE_CHUNK, n - done)
        prof = pp.profiled(fn, m, dev)
        work = (pp.device_events(prof) if dev.type == "cuda"
                else pp.cpu_ops(prof.events()))
        busy += union_us(work)
        events += len(work)
        done += m
    return busy / 1e6, events


def device_side(state: TrainState, step_fn: Step, batch: dict, steps: int,
                dev: torch.device) -> dict:
    """The first step's seconds, then ``steps`` steps on ``batch`` under
    the profiler: steps over the device's busy seconds, and its kernels
    and copies a step."""
    t0 = time.perf_counter()
    _, m = step_fn(state, batch)
    m["loss"].item()
    first = time.perf_counter() - t0

    busy, events = profiled_busy(lambda: step_fn(state, batch), steps, dev)
    if not busy > 0:
        raise RuntimeError("the profiler recorded no device work")
    return {"first_call_s": first, "device_side_steps_per_s": steps / busy,
            "device_side_method": "profiled busy",
            "device_events_per_step": events / steps}


def verdict(dispatch_only: float, k1: float) -> str:
    """JAX's rule on the two Python-loop controls, in the port's words."""
    if abs(dispatch_only - k1) < LAUNCH_BOUND * max(dispatch_only, k1):
        return ("launch-bound: dispatch_only ceilings with host_driven_k1 "
                "despite zero input work")
    return ("transfer-bound: dispatch_only reaches beyond host_driven_k1; "
            "the gap is the input path and the host->device batch transfer "
            "(compact transfer recovers part of it)")


def _loop(state: TrainState, step_fn: Step, batches, warm: int, steps: int
          ) -> float:
    """steps/s of ``steps`` steps after ``warm``, one sync after each run."""
    for _ in range(warm):
        state, m = step_fn(state, next(batches))
    m["loss"].item()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step_fn(state, next(batches))
    m["loss"].item()
    return steps / (time.perf_counter() - t0)


def run(steps: int = 600, k: int = 16, root: str = DEFAULT_ROOT,
        device: api.Device = "cuda", cfg: Optional[VSRConfig] = None,
        clips: Optional[dict] = None, out: Optional[str] = None,
        around: Optional[Around] = None, warm: Optional[int] = None,
        emit: Callable[[str], None] = print) -> dict:
    """The five controls at ``cfg`` (default ``VSRConfig()``) on PNG clips
    under ``root`` (``make_png_clips(root, **clips)``); each control runs
    inside ``around(name)`` when given, and the Python-loop controls after
    ``warm`` warm steps each when given, else after WARM's. Writes the
    record to ``out`` when given and returns it."""
    from video_super_resolution_tpu_torch.tools.bench_loader import make_png_clips

    dev = api.resolve_device(device)
    cfg = cfg or VSRConfig()
    around = around or (lambda name: contextlib.nullcontext())
    warms = {c: n if warm is None else warm for c, n in WARM.items()}
    make_png_clips(root, **(clips or {}))
    b, t, c = cfg.data.batch_size, cfg.model.window, cfg.data.crop_size
    state = create_train_state(cfg, dev)
    step_fn = make_train_step(cfg.train.charbonnier_eps)
    multi_fn = make_multi_train_step(cfg.train.charbonnier_eps)
    const = constant_batch(cfg, dev)
    rec = {"batch": b, "crop": c, "steps": steps, "k": k,
           "device": device_record(dev)}

    def show(key):
        emit(json.dumps({key: rec[key]}))

    with around("device_side"):
        rec.update(device_side(state, step_fn, const, steps, dev))
    show("device_side_steps_per_s")
    with around("dispatch_only"):
        rec["dispatch_only_steps_per_s"] = _loop(
            state, step_fn, itertools.repeat(const), warms["dispatch_only"],
            steps)
    show("dispatch_only_steps_per_s")

    ds = ClipDataset(hr_root=root, window=t, scale=cfg.model.scale,
                     crop_size=c, augment=True, seed=0)
    raw, close, rec["loader"] = make_batch_stream(cfg, ds)
    try:
        with around("host_driven_k1"):
            rec["host_driven_k1_steps_per_s"] = _loop(
                state, step_fn, device_prefetch(iter(raw), dev),
                warms["host_driven_k1"], steps)
        show("host_driven_k1_steps_per_s")
        with around("host_driven_k1_compact"):
            rec["host_driven_k1_compact_steps_per_s"] = _loop(
                state, step_fn, device_prefetch(compact_batches(raw), dev),
                warms["host_driven_k1_compact"], steps)
        show("host_driven_k1_compact_steps_per_s")

        it = iter(raw)

        def stacked():
            bs = [next(it) for _ in range(k)]
            return {key: torch.from_numpy(np.stack([x[key] for x in bs])
                                          ).to(dev) for key in bs[0]}

        with around(f"host_driven_k{k}"):
            _, m = multi_fn(state, stacked())          # warm
            m["loss"].item()
            n_disp = max(1, steps // k)
            t0 = time.perf_counter()
            for _ in range(n_disp):
                _, m = multi_fn(state, stacked())
            m["loss"].item()
            kk = n_disp * k / (time.perf_counter() - t0)
    finally:
        close()
    rec[f"host_driven_k{k}_steps_per_s"] = kk
    dev_sps = rec["device_side_steps_per_s"]
    k1 = rec["host_driven_k1_steps_per_s"]
    disp = rec["dispatch_only_steps_per_s"]
    rec["ratio_k1_vs_device"] = k1 / dev_sps
    rec["ratio_dispatch_only_vs_device"] = disp / dev_sps
    rec["ratio_k1_compact_vs_device"] = (
        rec["host_driven_k1_compact_steps_per_s"] / dev_sps)
    rec[f"ratio_k{k}_vs_device"] = kk / dev_sps
    rec["verdict"] = verdict(disp, k1)
    write_record(out, rec)
    emit(json.dumps(rec))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=DEFAULT_ROOT, help="PNG clips")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--out", default=os.path.join(
        REPO, "artifacts", "BENCH_dispatch_torch.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.steps, args.k, args.root, args.device, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

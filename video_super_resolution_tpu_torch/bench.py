"""Headline benchmark of the port: frames/s for 540p -> 4K x4 serving, or
train steps/s at batch 4, crop 64; the counterpart of the JAX repo's
``bench.py``.

    python -m video_super_resolution_tpu_torch.bench [--h 540 --w 960] \\
        [--frames 16 --warmup 2] [--quick] [--window N] [--batch B] \\
        [--train] [--record-baseline] [--cpu]

Prints ONE JSON line, JAX's keys in JAX's order:

- serving: ``metric`` (``frames_per_sec_per_chip_{h}x{w}_to_x4``, plus
  ``_b{batch}_w{window}`` when batch > 1 or window != 3), ``value``,
  ``unit`` (frames/s/chip), ``vs_baseline``, ``compile_s``, ``device``,
  ``out_shape`` (of one forward's output);
- ``--train``: ``metric`` (``train_steps_per_sec_b4_crop64``), ``value``,
  ``unit`` (steps/s), ``vs_baseline``, ``frames_per_s``, ``compile_s``,
  ``device``.

``device`` is the card's name and power limit as nvidia-smi gives them,
or ``"cpu"``. Then the port's own fields, which say what the wall time is
made of:

- ``device_ms_per_frame`` / ``device_ms_per_step``: CUDA events around
  each timed chain, from its first launch to its last kernel, idle gaps
  included (null on the CPU). On a host-bound forward they follow the
  host's pace, not the card's busy time;
- ``busy_ms_per_frame`` / ``busy_ms_per_step`` and ``idle_share`` (1 -
  busy / wall): the union of the device's kernels and copies in one more
  chain under torch.profiler (``bench_dispatch.profiled_busy``), taken
  after every timed chain: a profiler session can slow the launches that
  follow it. On the CPU: the union of the top-level host ops, which the
  profiler slows, so ``idle_share`` can fall below 0 there;
- ``launches``: the three kernel wrappers' counters over the timed
  chains, a forward (a frame at batch 1) or a step; 0 on the CPU, where
  the wrappers run their plain versions.

Method (JAX's): ``serving_config()`` with ``--window`` overriding its
window, for the train bench too (so its figure is not the train tools'
at ``VSRConfig()``); weights from ``cfg.train.seed``; bf16 compute.

- Serving: the window ``default_rng(0).random((batch, window, h, w, 3))``
  in f32; a chain is ``frames`` forwards through ``api.upscale_window``,
  the next window this one plus ``mean(out) * 1e-12``, ended by one
  ``.item()`` of the summed means. The first chain's wall is
  ``compile_s`` (with the kernels' nvcc build when ``_build/`` is cold);
  then ``warmup`` chains, the pull (the mean of 5 round trips of a
  trivial result of the window) and 3 timed chains: fps = frames / (mean
  chain - pull) * batch.
- Train: batch 4, LR crop 64, ``lr`` then ``hr`` from one
  ``default_rng(0)``; a chain is n = max(4, frames // 2) steps on that
  batch, each the step users train with (``training/step.py:
  make_train_step``: the forward in train mode, the Charbonnier loss,
  ``backward``, ``TrainState.apply_gradients`` with clip, Adam and
  schedule, and a PSNR proxy JAX's bench body lacks), ended by one
  ``.item()`` of the summed losses. One chain for
  ``compile_s``, the pull on an (8, 128) zero tensor, 2 timed chains:
  steps/s = n / (mean chain - pull). JAX's functional chain restarted
  from the same parameters each call; here the state trains on in place
  (the work a step is the same).

Every chain's sum must be finite. Nothing synchronises inside a chain but
its closing ``.item()``. Without ``--cpu`` it runs on the card and raises
without one. ``vs_baseline`` is against this package's
``bench_baseline.json`` (``--record-baseline`` writes the value and the
device there); the JAX repo's root ``bench_baseline.json`` holds TPU
figures and is never read.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig, serving_config
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.tools.bench_dispatch import (
    constant_batch,
    device_record,
    profiled_busy,
)
from video_super_resolution_tpu_torch.tools.bench_model_ab import (
    chain,
    pull_s,
    timed_chain,
)
from video_super_resolution_tpu_torch.tools.profile_prefix import (
    launch_counts,
    make_window,
)
from video_super_resolution_tpu_torch.training.state import TrainState, create_train_state
from video_super_resolution_tpu_torch.training.step import make_train_step

BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "bench_baseline.json")
TRAIN_BATCH, TRAIN_CROP = 4, 64
SERVING_REPS, TRAIN_REPS = 3, 2     # timed chains (JAX's)
PULLS = 5                           # round trips a pull (JAX's)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU, through the kernels' plain "
                         "versions (without it: the card, or an error)")
    ap.add_argument("--h", type=int, default=540)
    ap.add_argument("--w", type=int, default=960)
    ap.add_argument("--frames", type=int, default=16,
                    help="forwards a chain (train: max(4, frames // 2) "
                         "steps)")
    ap.add_argument("--warmup", type=int, default=2,
                    help="serving chains between the first and the pull")
    ap.add_argument("--quick", action="store_true",
                    help="180x320 shape for smoke runs")
    ap.add_argument("--train", action="store_true",
                    help="benchmark the training step (batch 4, crop 64) "
                         "instead of inference")
    ap.add_argument("--window", type=int, default=None,
                    help="temporal window override (e.g. 5 for config #3)")
    ap.add_argument("--batch", type=int, default=1, help="batch size")
    ap.add_argument("--record-baseline", action="store_true",
                    help="store this run as the vs_baseline reference")
    args = ap.parse_args(argv)
    if args.quick:
        args.h, args.w = 180, 320
    return args


def metric_name(args: argparse.Namespace) -> str:
    """JAX's metric name for these arguments (``bench.py:90,219-221``)."""
    if args.train:
        return f"train_steps_per_sec_b{TRAIN_BATCH}_crop{TRAIN_CROP}"
    name = f"frames_per_sec_per_chip_{args.h}x{args.w}_to_x4"
    if args.batch > 1 or (args.window or 3) != 3:
        name += f"_b{args.batch}_w{args.window or 3}"
    return name


def bench_config(args: argparse.Namespace,
                 cfg: Optional[VSRConfig] = None) -> VSRConfig:
    """``cfg`` (default ``serving_config()``) with ``--window`` applied."""
    cfg = cfg or serving_config()
    if args.window:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    window=args.window))
    return cfg


def serving_chain(model: VSRModel, window: torch.Tensor, n: int
                  ) -> torch.Tensor:
    """n forwards through ``api.upscale_window``, each on the last window
    plus mean(out) * 1e-12: the sum of the means, on the device."""
    return chain(lambda w: api.upscale_window(model, w), window, n)


def train_chain(state: TrainState, batch: Dict[str, torch.Tensor], n: int,
                eps: float) -> torch.Tensor:
    """n steps of ``make_train_step(eps)`` on ``batch`` (JAX's scan body,
    ``bench.py:53-66``, plus the step's PSNR proxy): the sum of the
    losses, on the device."""
    step = make_train_step(eps)
    total = torch.zeros((), device=batch["lr"].device)
    for _ in range(n):
        _, metrics = step(state, batch)
        total = total + metrics["loss"]
    return total


def measure(run: Callable[[], torch.Tensor], dev: torch.device, warmup: int,
            reps: int, calls: int, pull_on: Optional[torch.Tensor] = None,
            sums: Optional[List[float]] = None) -> dict:
    """The first chain (``compile_s``), ``warmup`` chains, the pull, ``reps``
    timed chains, then one chain under the profiler. A chain is ``run()``
    ended by its ``.item()``, ``calls`` forwards or steps. Each chain's sum
    goes to ``sums`` when given; a sum that is not finite raises."""
    t0 = time.perf_counter()
    got = [run().item()]
    compile_s = time.perf_counter() - t0
    got += [run().item() for _ in range(warmup)]
    pull = pull_s(dev, PULLS, pull_on)
    walls, device_ms = [], []
    launched = dict.fromkeys(launch_counts(), 0)
    for _ in range(reps):
        wall, ms, counts, total = timed_chain(run, dev)
        walls.append(wall)
        device_ms.append(ms)
        got.append(total)
        for k, v in counts.items():
            launched[k] += v
    if sums is not None:
        sums.extend(got)
    if not all(math.isfinite(s) for s in got):
        raise RuntimeError(f"bench: a chain's sum is not finite: {got}")
    busy_s, _ = profiled_busy(run, 1, dev)
    return {"compile_s": compile_s,
            "elapsed_s": max(statistics.fmean(walls) - pull, 1e-9),
            "device_ms": (None if dev.type != "cuda"
                          else statistics.fmean(device_ms)),
            "busy_ms": busy_s * 1e3,
            "launches": {k: v / (reps * calls) for k, v in launched.items()}}


def vs_baseline(metric: str, value: float, record: bool, device: str
                ) -> float:
    """value over the metric's recorded baseline (1.0 without one); with
    ``record`` the value and the device become the baseline."""
    rec = {}
    if os.path.exists(BASELINE_FILE):
        with open(BASELINE_FILE) as f:
            rec = json.load(f)
    baseline = rec.get(metric)
    if record:
        rec[metric] = value
        rec.setdefault("device", {})[metric] = device
        with open(BASELINE_FILE, "w") as f:
            json.dump(rec, f, indent=2)
    return round(value / baseline, 4) if baseline else 1.0


def port_fields(m: dict, per: int, unit: str, wall_ms: float) -> dict:
    """The port's fields of the line, a ``unit`` (frame or step) of which a
    chain holds ``per``, at ``wall_ms`` a unit."""
    busy = m["busy_ms"] / per
    return {f"device_ms_per_{unit}": (None if m["device_ms"] is None
                                      else m["device_ms"] / per),
            f"busy_ms_per_{unit}": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "launches": m["launches"]}


def bench_serving(args: argparse.Namespace, cfg: Optional[VSRConfig] = None,
                  sums: Optional[List[float]] = None) -> dict:
    """The serving line (``bench.py:150-248``); ``cfg`` replaces
    ``serving_config()``, ``sums`` receives each chain's sum."""
    dev = api.resolve_device("cpu" if args.cpu else "cuda")
    cfg = bench_config(args, cfg)
    model = api.build_model(cfg, dev, seed=cfg.train.seed)
    window = make_window(cfg, args.h, args.w, args.batch).to(dev)
    m = measure(lambda: serving_chain(model, window, args.frames), dev,
                args.warmup, SERVING_REPS, args.frames, window, sums)
    fps = args.frames / m["elapsed_s"] * args.batch
    out_shape = list(api.upscale_window(model, window).shape)
    metric = metric_name(args)
    device = device_record(dev)
    rec = {"metric": metric, "value": round(fps, 4), "unit": "frames/s/chip",
           "vs_baseline": vs_baseline(metric, fps, args.record_baseline,
                                      device),
           "compile_s": round(m["compile_s"], 1), "device": device,
           "out_shape": out_shape}
    rec.update(port_fields(m, args.frames * args.batch, "frame", 1e3 / fps))
    return rec


def bench_train(args: argparse.Namespace, cfg: Optional[VSRConfig] = None,
                sums: Optional[List[float]] = None) -> dict:
    """The train line (``bench.py:32-113``); ``cfg`` replaces
    ``serving_config()``, ``sums`` receives each chain's sum."""
    dev = api.resolve_device("cpu" if args.cpu else "cuda")
    cfg = bench_config(args, cfg)
    state = create_train_state(cfg, dev)
    batch = constant_batch(cfg.replace(data=dataclasses.replace(
        cfg.data, batch_size=TRAIN_BATCH, crop_size=TRAIN_CROP)), dev)
    n = max(4, args.frames // 2)
    eps = cfg.train.charbonnier_eps
    m = measure(lambda: train_chain(state, batch, n, eps), dev, 0,
                TRAIN_REPS, n, sums=sums)
    sps = n / m["elapsed_s"]
    metric = metric_name(args)
    device = device_record(dev)
    rec = {"metric": metric, "value": round(sps, 4), "unit": "steps/s",
           "vs_baseline": vs_baseline(metric, sps, args.record_baseline,
                                      device),
           "frames_per_s": round(sps * TRAIN_BATCH, 2),
           "compile_s": round(m["compile_s"], 1), "device": device}
    rec.update(port_fields(m, n, "step", 1e3 / sps))
    return rec


def main(argv: Optional[Sequence[str]] = None,
         cfg: Optional[VSRConfig] = None) -> int:
    args = parse_args(argv)
    rec = (bench_train if args.train else bench_serving)(args, cfg)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

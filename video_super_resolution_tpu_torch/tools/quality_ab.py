"""Trained-quality A/B of the model variants, the port's counterpart of the
JAX package's ``tools/quality_ab.py``.

    python -m video_super_resolution_tpu_torch.tools.quality_ab --steps 600 \\
        [--variants tpu_defaults,two_stage_head] [--out PATH] [--device cpu]

Each variant of ``VARIANTS`` (the JAX tool's seven: the defaults, the
reference-era head and feature warp, the wider espcn head, full-res depth,
flow at 1/2 res) trains from its own seeded weights under one protocol,
the JAX tool's:

- ``small_cfg``: a 3-level pyramid (8, 16, 32), estimator and context
  channels (24, 16), ``max_displacement=3``, a 12-channel depth net of 2
  levels, fusion and SR at 24 channels with 2 wide blocks, the gather
  warp; f32 compute, Adam at lr 4e-4 with 50 warm-up steps and a cosine
  decay, ``grad_clip=1.0``; LR crop 24, batch 4. ``train.steps`` is 1000
  whatever ``--steps`` is, as in the JAX tool: the cosine schedule is
  built for 1000 steps, so a 600-step run stops before it decays fully.
- ``make_data``: 8 ``moving_gradient_clip`` clips (HR 96x128, 7 frames,
  per-clip speeds from ``default_rng(0)``, clip i from seed i); ``clip6``
  and ``clip7`` are held out.
- ``run_variant``: ``ClipDataset(augment=True, seed=0)`` batches straight
  into ``training.step.make_train_step`` (which decodes them onto the
  device), not through ``training.loop.train``; the loss is the mean of
  the last 50 steps; then ``evaluate_all`` on the held-out clips (Y
  channel, border 4).

On the card the variant runs in f32 with TF32 off (the JAX tool ran f32,
so numerics are no confounder); ``--device cpu`` runs the plain versions.
One JSON line a variant, the JAX tool's keys (``variant``, ``psnr``,
``ssim``, ``final_loss``, ``train_s``, the last including the eval) plus
``steps`` and ``device`` (the card's name and power limit), unrounded;
the records in ``--out`` also carry ``dpsnr_vs_tpu_defaults``. The
weights come from the port's own generator, so only the deltas compare
with the JAX tool's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.data.dataset import ClipDataset
from video_super_resolution_tpu_torch.data.synthetic import moving_gradient_clip
from video_super_resolution_tpu_torch.training.state import TrainState

HELD_OUT = ("clip6", "clip7")
VARIANTS = {
    "tpu_defaults": {},
    "espcn_mid4x": {"sr_espcn_mid": 96},      # 4x sr_channels at toy scale
    "espcn_mid2x": {"sr_espcn_mid": 48},
    "warp_features": {"warp_features": True},
    "two_stage_head": {"sr_head_style": "two_stage"},
    "depth_full_res": {"depth_at_half_res": False},
    "flow_finest_l0": {"flow_finest_level": 0},
}


def small_cfg(**model_overrides) -> VSRConfig:
    """The A/B's config: ``VSRConfig()`` cut to toy widths, f32, with the
    variant's model fields."""
    cfg = VSRConfig()
    model = dataclasses.replace(
        cfg.model,
        pyramid_levels=3, pyramid_channels=(8, 16, 32),
        flow_estimator_channels=(24, 16), context_channels=(24, 16),
        max_displacement=3, depth_channels=12, depth_levels=2,
        fusion_channels=24, sr_channels=24, sr_blocks=2,
        sr_wide_blocks=True, warp_impl="gather",
        **model_overrides,
    )
    train = dataclasses.replace(
        cfg.train, compute_dtype="float32", lr=4e-4, warmup_steps=50,
        steps=1000, grad_clip=1.0,
    )
    data = dataclasses.replace(cfg.data, crop_size=24, batch_size=4)
    return cfg.replace(model=model, train=train, data=data)


def make_data(seed: int = 0, n_clips: int = 8, frames: int = 7,
              hr: int = 96, wr: int = 128) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    clips = {}
    for i in range(n_clips):
        dx = float(rng.uniform(-3, 3))
        dy = float(rng.uniform(-3, 3))
        clips[f"clip{i}"], _ = moving_gradient_clip(frames, hr, wr, dx, dy,
                                                    seed=i)
    return clips


def datasets(cfg: VSRConfig, clips: Mapping[str, np.ndarray]
             ) -> Tuple[ClipDataset, ClipDataset]:
    """The train set (augmented crops, seed 0) and the held-out set."""
    m = cfg.model
    train = ClipDataset(clips_hr={k: v for k, v in clips.items()
                                  if k not in HELD_OUT},
                        window=m.window, scale=m.scale,
                        crop_size=cfg.data.crop_size, augment=True, seed=0)
    held = ClipDataset(clips_hr={k: v for k, v in clips.items()
                                 if k in HELD_OUT},
                       window=m.window, scale=m.scale, augment=False)
    return train, held


def evaluate(model: torch.nn.Module, held: ClipDataset) -> Dict[str, dict]:
    """``evaluate_all`` of the model on the held-out clips (Y, border 4)."""
    from video_super_resolution_tpu_torch.evaluation.evaluate import evaluate_all

    return evaluate_all(api.eval_step, model, held, y_channel=True,
                        border_crop=4)


def run_variant(name: str, cfg: VSRConfig, clips: Mapping[str, np.ndarray],
                steps: int, log_every: int = 200, device: api.Device = "cuda",
                params: Optional[Mapping[str, torch.Tensor]] = None,
                emit: Callable[[str], None] = print
                ) -> Tuple[dict, TrainState]:
    """Train ``cfg`` for ``steps`` steps from seeded weights (or from the
    state dict ``params``), evaluate on the held-out clips; returns the
    record and the trained state."""
    from video_super_resolution_tpu_torch.tools.quality_serving import (
        _tf32_off,
        device_label,
    )
    from video_super_resolution_tpu_torch.training.state import create_train_state
    from video_super_resolution_tpu_torch.training.step import make_train_step

    dev = api.resolve_device(device)
    ds, held = datasets(cfg, clips)
    state = create_train_state(cfg, dev)
    if params is not None:
        state.model.load_state_dict(params)
    step = make_train_step(cfg.train.charbonnier_eps)
    with _tf32_off() if dev.type == "cuda" else contextlib.nullcontext():
        t0 = time.perf_counter()
        it = ds.batches(cfg.data.batch_size)
        losses = []
        for i in range(steps):
            state, metrics = step(state, next(it))
            losses.append(metrics["loss"])
            if (i + 1) % log_every == 0:
                emit(json.dumps({
                    "variant": name, "step": i + 1,
                    "loss": float(torch.stack(losses[-50:]).mean()),
                    "s": time.perf_counter() - t0}))
        res = evaluate(state.model, held)
        train_s = time.perf_counter() - t0
    last = [float(v) for v in torch.stack(losses[-50:]).cpu()]
    out = {"variant": name, "psnr": res["__average__"]["psnr"],
           "ssim": res["__average__"]["ssim"],
           "final_loss": float(np.mean(last)), "train_s": train_s,
           "steps": steps, "device": device_label(dev)}
    emit(json.dumps(out))
    return out, state


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", default="artifacts/QUALITY_ab_torch.jsonl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    api.resolve_device(args.device)

    clips = make_data()
    results = [run_variant(n, small_cfg(**VARIANTS[n]), clips, args.steps,
                           device=args.device)[0] for n in names]
    base = next((r for r in results if r["variant"] == "tpu_defaults"), None)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for r in results:
            r["dpsnr_vs_tpu_defaults"] = (None if base is None
                                          else r["psnr"] - base["psnr"])
            f.write(json.dumps(r) + "\n")
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

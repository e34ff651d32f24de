"""Command-line interface of the port, with the JAX package's subcommands,
arguments and dotted config overrides, plus ``--device``:

  python -m video_super_resolution_tpu_torch.cli train --hr-root ... --ckpt-dir ...
  python -m video_super_resolution_tpu_torch.cli eval  --hr-root ... --ckpt-dir ...
  python -m video_super_resolution_tpu_torch.cli infer --lr-root ... --out-dir ... --ckpt-dir ...
  python -m video_super_resolution_tpu_torch.cli import-weights --torch-ckpt ...

Dotted overrides: --set model.window=5 train.lr=2e-4. ``--device`` is
``cuda`` unless given (``--device cpu`` runs on the CPU); without a GPU a
CUDA run raises. The config JSON is the JAX package's format; checkpoints
are the port's own (``training/checkpoint.py``), not Orbax's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List

import numpy as np

from video_super_resolution_tpu_torch.config import VSRConfig


def _apply_overrides(cfg: VSRConfig, overrides: List[str]) -> VSRConfig:
    d = dataclasses.asdict(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"bad --set override (want key=value): {ov}")
        key, val = ov.split("=", 1)
        parts = key.split(".")
        node = d
        for p in parts[:-1]:
            if p not in node:
                raise SystemExit(f"unknown config path: {key}")
            node = node[p]
        leaf = parts[-1]
        if leaf not in node:
            raise SystemExit(f"unknown config field: {key}")
        old = node[leaf]
        if isinstance(old, bool):
            node[leaf] = val.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            node[leaf] = int(val)
        elif isinstance(old, float):
            node[leaf] = float(val)
        elif isinstance(old, (list, tuple)):
            node[leaf] = [int(x) for x in val.split(",")]
        else:
            node[leaf] = val
    return VSRConfig.from_dict(d)


def _load_cfg(args) -> VSRConfig:
    cfg = VSRConfig()
    if args.config:
        with open(args.config) as f:
            cfg = VSRConfig.from_json(f.read())
    return _apply_overrides(cfg, args.set or [])


def _add_common(p):
    p.add_argument("--config", help="VSRConfig JSON file")
    p.add_argument("--set", nargs="*", metavar="KEY=VAL",
                   help="dotted config overrides")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")


def _restore(args):
    """(config, train state) of the newest checkpoint in args.ckpt_dir; the
    checkpoint's stored config wins over --config/--set, as in the JAX
    CLI."""
    from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
    from video_super_resolution_tpu_torch.training.state import create_train_state

    cfg = _load_cfg(args)
    mgr = CheckpointManager(args.ckpt_dir)
    cfg = mgr.restore_config() or cfg
    state, _ = mgr.restore(create_train_state(cfg, args.device))
    if state is None:
        raise SystemExit(f"no checkpoint found in {args.ckpt_dir}")
    return cfg, state


def cmd_train(args):
    from video_super_resolution_tpu_torch.data.dataset import ClipDataset
    from video_super_resolution_tpu_torch.training.loop import train

    cfg = _load_cfg(args)
    if args.ckpt_dir:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    ckpt_dir=args.ckpt_dir))
    train_ds = ClipDataset(
        hr_root=args.hr_root, lr_root=args.lr_root,
        window=cfg.model.window, scale=cfg.model.scale,
        crop_size=cfg.data.crop_size, augment=cfg.data.augment,
        edge_mode=cfg.data.edge_mode, seed=cfg.train.seed)
    eval_ds = None
    if args.eval_hr_root:
        eval_ds = ClipDataset(
            hr_root=args.eval_hr_root, lr_root=args.eval_lr_root,
            window=cfg.model.window, scale=cfg.model.scale, augment=False,
            edge_mode=cfg.data.edge_mode)
    out = train(cfg, train_ds, eval_ds, max_steps=args.steps,
                eval_every=args.eval_every, device=args.device)
    if out["eval"]:
        print(json.dumps(out["eval"], indent=2))


def cmd_eval(args):
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.data.dataset import ClipDataset
    from video_super_resolution_tpu_torch.evaluation.evaluate import evaluate_all

    cfg, state = _restore(args)
    ds = ClipDataset(hr_root=args.hr_root, lr_root=args.lr_root,
                     window=cfg.model.window, scale=cfg.model.scale,
                     augment=False, edge_mode=cfg.data.edge_mode)
    res = evaluate_all(api.eval_step, state.model, ds,
                       cfg.data.y_channel_eval, cfg.data.border_crop)
    print(json.dumps({"step": state.step, **res}, indent=2))


def cmd_infer(args):
    from PIL import Image

    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.data.dataset import list_clips, load_frame

    cfg, state = _restore(args)
    os.makedirs(args.out_dir, exist_ok=True)
    for clip, frames in list_clips(args.lr_root).items():
        outd = os.path.join(args.out_dir, clip)
        os.makedirs(outd, exist_ok=True)
        hr = api.upscale_clip(state.model,
                              np.stack([load_frame(f) for f in frames]),
                              cfg.data.edge_mode)
        for c, img in enumerate(hr):
            Image.fromarray((np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
                            ).save(os.path.join(outd, f"{c:08d}.png"))
        print(f"{clip}: {len(frames)} frames -> {outd}", file=sys.stderr)


def cmd_import_weights(args):
    from video_super_resolution_tpu_torch.training.import_torch import (
        load_torch_checkpoint,
    )

    sd = load_torch_checkpoint(args.torch_ckpt)
    print(json.dumps({k: list(v.shape) for k, v in sd.items()}, indent=2))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vsr-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="train the VSR model")
    _add_common(p)
    p.add_argument("--hr-root", required=True)
    p.add_argument("--lr-root")
    p.add_argument("--eval-hr-root")
    p.add_argument("--eval-lr-root")
    p.add_argument("--ckpt-dir")
    p.add_argument("--steps", type=int)
    p.add_argument("--eval-every", type=int)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="evaluate a checkpoint (PSNR/SSIM)")
    _add_common(p)
    p.add_argument("--hr-root", required=True)
    p.add_argument("--lr-root")
    p.add_argument("--ckpt-dir", required=True)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("infer", help="x4 upscale LR clips to PNG frames")
    _add_common(p)
    p.add_argument("--lr-root", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("import-weights",
                       help="inspect a torch checkpoint's tensors")
    _add_common(p)
    p.add_argument("--torch-ckpt", required=True)
    p.set_defaults(fn=cmd_import_weights)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

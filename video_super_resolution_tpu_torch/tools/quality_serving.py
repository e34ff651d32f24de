"""Serving-path quality check: the bf16 kernel path against the f32 oracle.

The clause: the model as it serves (bf16 compute through the port's three
CUDA kernels) stays within 0.05 dB PSNR of the f32 oracle (f32 through the
plain PyTorch versions on the CPU), on every held-out clip and on average,
with weights trained at the production width. The port's counterpart of
the JAX package's ``tools/quality_serving.py``, with its variants, clip
recipes and seeds:

    python -m video_super_resolution_tpu_torch.tools.quality_serving train \\
        --variant hard --steps 12000 --ckpt-dir RUN
    python -m video_super_resolution_tpu_torch.tools.quality_serving eval \\
        --ckpt-dir RUN --path serving f32_kernels oracle
    python -m video_super_resolution_tpu_torch.tools.quality_serving verdict \\
        --ckpt-dir RUN

- ``train``: ``production_cfg(variant, steps)`` (full width, bf16 compute,
  f32 master parameters, LR crop 64, batch 4, lr 2e-4 cosine) through
  ``training.loop.train`` on in-memory synthetic clips (HR 384x512, 7
  frames). Checkpoints go to RUN; a rerun resumes from the newest one with
  the sample stream fast-forwarded to its step, so a run split at a
  checkpoint (``--until``) ends with the parameters of an uninterrupted
  one. At the end it writes RUN/model.pt (the model's state dict),
  RUN/config.json and RUN/run.json (variant, step, steps/s, the loss and
  ``psnr_proxy`` curve).
- ``eval``: for each path of ``EVAL_PATHS``, the model at the path's dtype
  on its device with RUN's weights, ``evaluate_all`` over the held-out
  clips (HR 1152x2048 = LR 288x512, 7 frames; Y channel, border 4, batch
  4 windows); one record a path, ``eval_<path>.json`` in RUN (or
  ``--out``).
- ``verdict``: delta = path - oracle per clip and on average; the clause
  holds when every |delta| of ``serving`` and ``f32_kernels`` is at most
  0.05 dB; for the hard variants, ``regime`` says whether every oracle
  PSNR lies in 25-32 dB. Prints one JSON line, exits 1 when the clause
  does not hold.

The card paths raise without a GPU; the CPU paths are the oracle by
definition. ``--set`` overrides config fields as the CLI's does, and
``--hr-size`` and ``--frames`` set the clip sizes: small ones run the whole
tool on the CPU in seconds (``--device cpu`` for ``train``).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import glob
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.data import synthetic as syn
from video_super_resolution_tpu_torch.data.dataset import ClipDataset

EVAL_HR_H, EVAL_HR_W = 1152, 2048     # LR 288x512
TRAIN_HR_H, TRAIN_HR_W = 384, 512
FRAMES = 7
# hard-regime texture slope: the fine octaves dominate, so the converged
# model lands at 25-32 dB (the bicubic baseline of the eval clips ~25 dB)
ROUGH = 1.1
VARIANTS = ("espcn", "two_stage", "espcn_mid", "espcn_d4", "hard", "hard_d2")
TOLERANCE_DB = 0.05
REGIME_DB = (25.0, 32.0)
# path: (compute dtype, device, route)
EVAL_PATHS = {
    "serving": ("bfloat16", "cuda", "kernels"),
    "f32_kernels": ("float32", "cuda", "kernels, TF32 off"),
    "bf16_plain": ("bfloat16", "cpu", "plain versions"),
    "oracle": ("float32", "cpu", "plain versions"),
}
JUDGED = ("serving", "f32_kernels")
# clip sets of at least this many pixels x frames a clip are made in
# parallel processes (one 1152x2048 clip is tens of seconds of numpy;
# small ones would wait longer for the processes to start)
PARALLEL_PIXELS = 1 << 20


def production_cfg(variant: str, steps: int) -> VSRConfig:
    """The dataclass defaults at full width with the variant's model
    options and the quality runs' training settings. Every variant pins
    ``depth_res_divisor`` (``hard`` at 4, the serving configuration's)."""
    model_kw = {"depth_res_divisor": 2}
    if variant == "two_stage":
        model_kw["sr_head_style"] = "two_stage"
    elif variant == "espcn_mid":
        model_kw["sr_espcn_mid"] = 64
    elif variant in ("espcn_d4", "hard"):
        model_kw["depth_res_divisor"] = 4
    elif variant not in ("espcn", "hard_d2"):
        raise ValueError(f"unknown variant {variant}")
    cfg = VSRConfig()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model_kw),
        train=dataclasses.replace(cfg.train, steps=steps,
                                  warmup_steps=min(500, steps // 10),
                                  lr=2e-4, lr_schedule="cosine"),
        data=dataclasses.replace(cfg.data, crop_size=64, batch_size=4))


# ------------------------------------------------------------------ clips

def _moving(frames, h, w, dx, dy, seed):
    return syn.moving_gradient_clip(frames, h, w, dx, dy, seed=seed)[0]


def _noisy_detail(frames, h, w, dx, dy, seed, noise_seed):
    return syn.add_noise(syn.detail_clip(frames, h, w, dx, dy, seed=seed,
                                         rough=ROUGH), 0.04, seed=noise_seed)


def _generate(recipes: Mapping[str, Callable[[], np.ndarray]],
              pixels: int) -> Dict[str, np.ndarray]:
    """Each recipe's clip (of ``pixels`` pixels x frames); at least
    PARALLEL_PIXELS, one spawned process a clip, up to the CPU count."""
    workers = min(len(recipes), os.cpu_count() or 1)
    if pixels < PARALLEL_PIXELS or workers < 2:
        return {k: f() for k, f in recipes.items()}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futures = {k: pool.submit(f) for k, f in recipes.items()}
        return {k: f.result() for k, f in futures.items()}


def make_train_clips(h: int = TRAIN_HR_H, w: int = TRAIN_HR_W,
                     frames: int = FRAMES) -> Dict[str, np.ndarray]:
    """8 clips: 6 translations (up to +-6 HR px/frame), 2 zooms."""
    p = functools.partial
    rng = np.random.default_rng(1234)
    recipes = {}
    for i in range(6):
        dx = float(rng.uniform(-6, 6))
        dy = float(rng.uniform(-6, 6))
        recipes[f"train_t{i}"] = p(_moving, frames, h, w, dx, dy, 100 + i)
    recipes["train_z0"] = p(syn.zooming_clip, frames, h, w, 1.015, seed=200)
    recipes["train_z1"] = p(syn.zooming_clip, frames, h, w, 0.985, seed=201)
    return _generate(recipes, h * w * frames)


def make_train_clips_hard(h: int = TRAIN_HR_H, w: int = TRAIN_HR_W,
                          frames: int = FRAMES) -> Dict[str, np.ndarray]:
    """9 hard-regime clips: 3 occlusion/layered, 2 detail translations, 2
    shears (flow gradients 0.33 and 0.71 px/px a frame step), 1 zoom, 1
    noisy translation."""
    p = functools.partial
    rng = np.random.default_rng(4321)
    recipes = {f"htrain_occ{i}": p(syn.layered_clip, frames, h, w,
                                   seed=500 + i, n_layers=3, max_speed=3.0,
                                   rough=ROUGH) for i in range(3)}
    for i in range(2):
        dx = float(rng.uniform(-5, 5))
        dy = float(rng.uniform(-5, 5))
        recipes[f"htrain_tex{i}"] = p(syn.detail_clip, frames, h, w, dx, dy,
                                      seed=510 + i, rough=ROUGH)
    recipes["htrain_shear0"] = p(syn.shear_clip, frames, h, w, amp=2.5,
                                 wavelength=48, seed=520, rough=ROUGH)
    recipes["htrain_shear1"] = p(syn.shear_clip, frames, h, w, amp=3.5,
                                 wavelength=31, seed=521, rough=ROUGH)
    recipes["htrain_zoom"] = p(syn.zooming_clip, frames, h, w, 1.02,
                               seed=530, rough=ROUGH)
    recipes["htrain_noise"] = p(_noisy_detail, frames, h, w, 2.0, 1.0, 540, 541)
    return _generate(recipes, h * w * frames)


def make_eval_clips(h: int = EVAL_HR_H, w: int = EVAL_HR_W,
                    frames: int = FRAMES) -> Dict[str, np.ndarray]:
    """3 held-out clips: slow and fast translation, zoom."""
    p = functools.partial
    return _generate({
        "eval_slow": p(_moving, frames, h, w, 1.7, -1.1, 300),
        "eval_fast": p(_moving, frames, h, w, -7.0, 4.5, 301),
        "eval_zoom": p(syn.zooming_clip, frames, h, w, 1.012, seed=302),
    }, h * w * frames)


def make_eval_clips_hard(h: int = EVAL_HR_H, w: int = EVAL_HR_W,
                         frames: int = FRAMES) -> Dict[str, np.ndarray]:
    """6 held-out hard-regime clips; the shears' flow gradients are 0.33
    and 0.71 px/px a frame step."""
    p = functools.partial
    return _generate({
        "heval_tex": p(syn.detail_clip, frames, h, w, 1.7, -1.1, seed=600,
                       rough=ROUGH),
        "heval_occ": p(syn.layered_clip, frames, h, w, seed=601, n_layers=3,
                       max_speed=3.0, rough=ROUGH),
        "heval_shear033": p(syn.shear_clip, frames, h, w, amp=2.5,
                            wavelength=48, seed=602, rough=ROUGH),
        "heval_shear071": p(syn.shear_clip, frames, h, w, amp=3.5,
                            wavelength=31, seed=603, rough=ROUGH),
        "heval_noise": p(_noisy_detail, frames, h, w, 2.0, 1.0, 604, 605),
        "heval_zoom": p(syn.zooming_clip, frames, h, w, 1.012, seed=606,
                        rough=ROUGH),
    }, h * w * frames)


def _hard(variant: str) -> bool:
    return variant.startswith("hard")


# -------------------------------------------------------------- run files

def write_state(ckpt_dir: str, cfg: VSRConfig, variant: str,
                state_dict: Mapping[str, torch.Tensor], step: int = 0,
                calls: Sequence[dict] = (), curve: Sequence[dict] = ()
                ) -> None:
    """The run's weights (model.pt, a host copy of ``state_dict``), its
    config (config.json, the JAX package's format) and run.json (variant,
    step, one entry a ``train`` call, the logged curve)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(ckpt_dir, "model.pt"))
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(ckpt_dir, "run.json"), "w") as f:
        json.dump({"variant": variant, "step": step, "calls": list(calls),
                   "curve": list(curve)}, f, indent=1)


def load_run(ckpt_dir: str) -> Tuple[VSRConfig, dict, Dict[str, torch.Tensor]]:
    """(config, run.json, state dict) that ``write_state`` wrote."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = VSRConfig.from_json(f.read())
    with open(os.path.join(ckpt_dir, "run.json")) as f:
        run = json.load(f)
    state = torch.load(os.path.join(ckpt_dir, "model.pt"), map_location="cpu",
                       weights_only=True)
    return cfg, run, state


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU and its thread count."""
    if dev.type != "cuda":
        return f"cpu, {torch.get_num_threads()} threads"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={torch.cuda.current_device() if dev.index is None else dev.index}"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


# ------------------------------------------------------------------ train

def train(variant: str, steps: int, ckpt_dir: str, device: api.Device = "cuda",
          until: Optional[int] = None, log_every: int = 200,
          overrides: Sequence[str] = (),
          hr_size: Tuple[int, int] = (TRAIN_HR_H, TRAIN_HR_W),
          frames: int = FRAMES) -> dict:
    """Train ``production_cfg(variant, steps)`` (with ``overrides``, the
    CLI's dotted ``--set``) to step ``until`` (default ``steps``) through
    ``training.loop.train``, resuming from the newest checkpoint in
    ``ckpt_dir`` (which must hold a run of the same variant and config);
    then ``write_state``. Returns this call's start and end step, seconds,
    steps/s, device and last logged point."""
    from video_super_resolution_tpu_torch.cli import _apply_overrides
    from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
    from video_super_resolution_tpu_torch.training.loop import train as train_loop

    dev = api.resolve_device(device)
    cfg = _apply_overrides(production_cfg(variant, steps), list(overrides))
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, ckpt_dir=os.path.abspath(ckpt_dir), log_every=log_every))
    mgr = CheckpointManager(ckpt_dir)
    saved = mgr.restore_config()
    if saved is not None and saved.replace(train=dataclasses.replace(
            saved.train, ckpt_dir=cfg.train.ckpt_dir,
            log_every=log_every)) != cfg:
        raise ValueError(f"{ckpt_dir} holds checkpoints of another config")
    start = mgr.latest_step() or 0
    prior = {"calls": [], "variant": variant}
    if start and os.path.exists(os.path.join(ckpt_dir, "run.json")):
        with open(os.path.join(ckpt_dir, "run.json")) as f:
            prior = json.load(f)
    if prior["variant"] != variant:
        raise ValueError(f"{ckpt_dir} holds a run of {prior['variant']}")

    make = make_train_clips_hard if _hard(variant) else make_train_clips
    ds = ClipDataset(clips_hr=make(*hr_size, frames=frames),
                     window=cfg.model.window, scale=cfg.model.scale,
                     crop_size=cfg.data.crop_size, augment=True, seed=0)
    stream = ds.batches(cfg.data.batch_size)
    for _ in range(start):      # the samples the steps before `start` drew
        next(stream)

    t0 = time.perf_counter()
    state = train_loop(cfg, ds, max_steps=until or steps, device=dev)["state"]
    wall = time.perf_counter() - t0
    curve = []
    log_path = os.path.join(ckpt_dir, "train.jsonl")
    with open(log_path) as f:
        for line in f:
            r = json.loads(line)
            if "loss" in r:
                curve.append({"step": r["step"], "loss": r["loss"],
                              "psnr_proxy": r["psnr_proxy"],
                              "steps_per_s": r["steps_per_s"], "s": r["t"]})
    call = {"start": start, "end": state.step, "train_s": wall,
            "steps_per_s": (state.step - start) / wall,
            "device": device_label(dev)}
    write_state(ckpt_dir, cfg, variant, state.model.state_dict(), state.step,
                prior["calls"] + [call], curve)
    return {"variant": variant, "step": state.step, **call,
            "final": curve[-1] if curve else None}


# ------------------------------------------------------------------- eval

@contextlib.contextmanager
def _tf32_off():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def eval_dataset(variant: str, cfg: VSRConfig,
                 hr_size: Tuple[int, int] = (EVAL_HR_H, EVAL_HR_W),
                 frames: int = FRAMES) -> ClipDataset:
    """The variant's held-out clips, degraded once."""
    make = make_eval_clips_hard if _hard(variant) else make_eval_clips
    return ClipDataset(clips_hr=make(*hr_size, frames=frames),
                       window=cfg.model.window, scale=cfg.model.scale,
                       augment=False)


def evaluate_path(ckpt_dir: str, path: str, dataset: ClipDataset,
                  batch_windows: int = 4) -> dict:
    """One path's record: the run's weights at the path's dtype on its
    device, ``evaluate_all`` (Y channel, border 4) over ``dataset``."""
    from video_super_resolution_tpu_torch.evaluation.evaluate import evaluate_all

    dtype, device, route = EVAL_PATHS[path]
    dev = api.resolve_device(device)
    cfg, run, state = load_run(ckpt_dir)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))
    model = api.build_model(cfg, dev)
    model.load_state_dict(state)
    with _tf32_off() if path == "f32_kernels" else contextlib.nullcontext():
        t0 = time.perf_counter()
        res = evaluate_all(api.eval_step, model, dataset, y_channel=True,
                           border_crop=4, batch_windows=batch_windows)
        eval_s = time.perf_counter() - t0
        tf32 = (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32)
    avg = res.pop("__average__")
    lr = next(dataset.eval_windows(dataset.clip_names[0]))["lr"]
    return {"variant": run["variant"], "step": run["step"], "path": path,
            "psnr": avg["psnr"], "ssim": avg["ssim"], "frames": avg["frames"],
            "per_clip": res, "eval_s": eval_s, "lr_shape": list(lr.shape[2:4]),
            "compute_dtype": dtype, "route": route,
            "tf32": tf32 if dev.type == "cuda" else None,
            "device": device_label(dev)}


def evaluate(ckpt_dir: str, paths: Sequence[str], out: Optional[str] = None,
             batch_windows: int = 4,
             hr_size: Tuple[int, int] = (EVAL_HR_H, EVAL_HR_W),
             frames: int = FRAMES) -> Dict[str, dict]:
    """``evaluate_path`` for each of ``paths`` on one set of clips, each
    record written to ``out`` (default ``ckpt_dir``) as eval_<path>.json.
    A card path raises without a GPU before anything is built."""
    for p in paths:
        api.resolve_device(EVAL_PATHS[p][1])
    cfg, run, _ = load_run(ckpt_dir)
    ds = eval_dataset(run["variant"], cfg, hr_size, frames)
    out = out or ckpt_dir
    os.makedirs(out, exist_ok=True)
    records = {}
    for p in paths:
        records[p] = evaluate_path(ckpt_dir, p, ds, batch_windows)
        with open(os.path.join(out, f"eval_{p}.json"), "w") as f:
            json.dump(records[p], f, indent=1)
        print(json.dumps({p: records[p]}), flush=True)
    return records


# ---------------------------------------------------------------- verdict

def load_records(directory: str) -> Dict[str, dict]:
    """The eval_<path>.json records in ``directory``, by path."""
    records = {}
    for fn in sorted(glob.glob(os.path.join(directory, "eval_*.json"))):
        with open(fn) as f:
            rec = json.load(f)
        records[rec["path"]] = rec
    return records


def verdict(records: Mapping[str, dict]) -> dict:
    """delta = path - oracle (dB) per clip and on average for every path
    beside the oracle; ``holds`` when each |delta| of ``serving`` and
    ``f32_kernels`` is at most TOLERANCE_DB; ``regime`` (hard variants
    only) when every oracle PSNR lies in REGIME_DB."""
    missing = [p for p in ("oracle",) + JUDGED if p not in records]
    if missing:
        raise ValueError(f"no eval record for {missing}")
    oracle = records["oracle"]
    runs = {(r["variant"], r["step"]) for r in records.values()}
    if len(runs) != 1:
        raise ValueError(f"records of different runs: {sorted(runs)}")
    clips = sorted(oracle["per_clip"])
    deltas = {}
    for path, rec in records.items():
        if path == "oracle":
            continue
        if sorted(rec["per_clip"]) != clips:
            raise ValueError(f"{path}: clips {sorted(rec['per_clip'])} != {clips}")
        deltas[path] = {
            "per_clip": {c: rec["per_clip"][c]["psnr"] - oracle["per_clip"][c]["psnr"]
                         for c in clips},
            "average": rec["psnr"] - oracle["psnr"]}
    judged = [abs(v) for p in JUDGED
              for v in (*deltas[p]["per_clip"].values(), deltas[p]["average"])]
    lo, hi = REGIME_DB
    oracle_psnr = {c: oracle["per_clip"][c]["psnr"] for c in clips}
    return {
        "variant": oracle["variant"], "step": oracle["step"],
        "tolerance_db": TOLERANCE_DB, "oracle_psnr": oracle_psnr,
        "oracle_average": oracle["psnr"], "deltas": deltas,
        "max_abs_delta_db": (math.nan if any(map(math.isnan, judged))
                             else max(judged)),
        "holds": all(d <= TOLERANCE_DB for d in judged),
        "regime": (all(lo <= v <= hi for v in oracle_psnr.values())
                   if _hard(oracle["variant"]) else None),
    }


# -------------------------------------------------------------------- CLI

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    tp = sub.add_parser("train")
    tp.add_argument("--variant", default="espcn", choices=VARIANTS)
    tp.add_argument("--steps", type=int, default=12000)
    tp.add_argument("--until", type=int,
                    help="stop after this step (a chunk of the run)")
    tp.add_argument("--log-every", type=int, default=200)
    tp.add_argument("--ckpt-dir", required=True)
    tp.add_argument("--device", default="cuda")
    tp.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                    help="dotted config overrides")
    tp.add_argument("--hr-size", type=int, nargs=2,
                    default=[TRAIN_HR_H, TRAIN_HR_W], metavar=("H", "W"))
    tp.add_argument("--frames", type=int, default=FRAMES)
    ep = sub.add_parser("eval")
    ep.add_argument("--ckpt-dir", required=True)
    ep.add_argument("--path", nargs="+", default=["serving"],
                    choices=tuple(EVAL_PATHS))
    ep.add_argument("--out", help="directory of the records (default: "
                    "--ckpt-dir)")
    ep.add_argument("--batch-windows", type=int, default=4)
    ep.add_argument("--hr-size", type=int, nargs=2,
                    default=[EVAL_HR_H, EVAL_HR_W], metavar=("H", "W"))
    ep.add_argument("--frames", type=int, default=FRAMES)
    vp = sub.add_parser("verdict")
    vp.add_argument("--ckpt-dir", required=True)
    vp.add_argument("--out", help="directory of the records (default: "
                    "--ckpt-dir)")
    args = ap.parse_args(argv)

    if args.cmd == "train":
        rec = train(args.variant, args.steps, args.ckpt_dir, args.device,
                    args.until, args.log_every, args.set, tuple(args.hr_size),
                    args.frames)
        print(json.dumps(rec), flush=True)
    elif args.cmd == "eval":
        evaluate(args.ckpt_dir, args.path, args.out, args.batch_windows,
                 tuple(args.hr_size), args.frames)
    else:
        out = args.out or args.ckpt_dir
        v = verdict(load_records(out))
        with open(os.path.join(out, "verdict.json"), "w") as f:
            json.dump(v, f, indent=1)
        print(json.dumps(v), flush=True)
        return 0 if v["holds"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Training loop, as the JAX package's ``training/loop.py``: restore the
latest checkpoint, then steps from a host batch stream with periodic logs,
checkpoints and evaluation.

The batches come from the Python ``ClipDataset`` (the JAX package's native
C++ loader is not ported) and are sent two steps ahead: each is copied
into pinned memory and queued with a non-blocking copy, so the host's work
on it overlaps the steps before it. The copy itself runs on the compute
stream, in order between steps.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Iterator, Optional

import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import TrainConfig, VSRConfig
from video_super_resolution_tpu_torch.data.dataset import ClipDataset
from video_super_resolution_tpu_torch.evaluation.evaluate import evaluate_all
from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
from video_super_resolution_tpu_torch.training.state import create_train_state
from video_super_resolution_tpu_torch.training.step import make_train_step
from video_super_resolution_tpu_torch.utils.logging import MetricsLogger


def device_prefetch(batches: Iterator[dict], device: torch.device,
                    depth: int = 2) -> Iterator[dict]:
    """Keep ``depth`` batches queued for ``device`` ahead of the consumer:
    numpy batches go through pinned host memory and non-blocking copies.
    Only the host side overlaps: the host's work on batch t + 1 runs while
    the device works on step t, but the copies go onto the current stream,
    so on the device each runs between two steps, not under one."""
    buf = collections.deque()
    for batch in batches:
        moved = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            moved[k] = t
        buf.append(moved)
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def train(
    cfg: VSRConfig,
    train_ds: ClipDataset,
    eval_ds: Optional[ClipDataset] = None,
    max_steps: Optional[int] = None,
    eval_every: Optional[int] = None,
    device: api.Device = "cuda",
) -> Dict:
    """Train ``cfg``'s model on ``train_ds`` up to ``max_steps`` (default
    ``cfg.train.steps``) updates, resuming from the newest checkpoint in
    ``cfg.train.ckpt_dir``, which must be set: the config's default is
    one fixed directory that every run on the host would share, and two
    runs there would resume each other's checkpoints. Returns {"state",
    "eval", "ckpt"}."""
    if cfg.train.ckpt_dir == TrainConfig.ckpt_dir:
        raise ValueError(
            f"set cfg.train.ckpt_dir: the default {TrainConfig.ckpt_dir} "
            "is shared by every run on the host")
    dev = api.resolve_device(device)
    steps = max_steps or cfg.train.steps
    step_fn = make_train_step(cfg.train.charbonnier_eps, mesh=cfg.mesh)
    state = create_train_state(cfg, dev)
    mgr = CheckpointManager(cfg.train.ckpt_dir, keep=cfg.train.keep_ckpts)
    mgr.restore(state)
    start_step = state.step

    logger = MetricsLogger(cfg.train.ckpt_dir, "train")
    batches = device_prefetch(train_ds.batches(cfg.data.batch_size), dev)
    last_eval: Dict = {}
    t_last = time.time()
    for step in range(start_step, steps):
        state, metrics = step_fn(state, next(batches))

        if (step + 1) % cfg.train.log_every == 0:
            vals = {k: float(v) for k, v in metrics.items()}   # waits
            now = time.time()
            sps = cfg.train.log_every / (now - t_last)
            t_last = now
            logger.log(step + 1, {**vals, "steps_per_s": sps,
                                  "frames_per_s": sps * cfg.data.batch_size})
        if (step + 1) % cfg.train.ckpt_every == 0 or step + 1 == steps:
            mgr.save(step + 1, state, cfg)
        if eval_ds is not None and eval_every and (step + 1) % eval_every == 0:
            last_eval = evaluate_all(
                api.eval_step, state.model, eval_ds,
                cfg.data.y_channel_eval, cfg.data.border_crop)
            avg = last_eval["__average__"]
            logger.log(step + 1, {"eval_psnr": avg["psnr"],
                                  "eval_ssim": avg["ssim"]}, prefix="eval/")
    mgr.wait()
    logger.close()
    return {"state": state, "eval": last_eval, "ckpt": mgr}

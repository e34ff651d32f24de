"""Training loop, as the JAX package's ``training/loop.py``: restore the
latest checkpoint, then steps from a host batch stream with periodic logs,
checkpoints and evaluation.

The batches come from the native C++ loader (``data/native_loader.py``)
when the dataset is path-backed and HR-only and the loader can be built,
and from the Python ``ClipDataset`` otherwise, as the JAX package's
``_make_batch_stream`` decides; the choice is logged as ``native_loader``
(1 or 0) at the start step. With the native loader and bf16 compute the
batches travel compact: HR as uint8 (exact: the loader's HR is 8-bit PNG
data / 255) and LR as bf16 (the model casts it to bf16 anyway), decoded
on the device by the train step; ``VSR_COMPACT_TRANSFER=0`` sends them as
f32, as the JAX package reads the same variable (default "1"). They are sent two steps ahead: each is
copied into pinned memory and queued with a non-blocking copy, so the
host's work on it overlaps the steps before it. The copy itself runs on
the compute stream, in order between steps.

With ``cfg.mesh`` of more than one device (one process a rank, in a
process group that the caller or torchrun started: ``cli train`` calls
``runtime.mesh.initialize_distributed``), the train step runs on that mesh
(``training/step.py``); ``cfg.data.batch_size`` is the global batch, and
each data rank draws batch_size / data samples a step from its own stream
(seed ``cfg.train.seed`` + its data coordinate). Rank 0 writes the
checkpoints and the log; every rank restores.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import TrainConfig, VSRConfig
from video_super_resolution_tpu_torch.data import native_loader
from video_super_resolution_tpu_torch.data.dataset import ClipDataset
from video_super_resolution_tpu_torch.evaluation.evaluate import evaluate_all
from video_super_resolution_tpu_torch.runtime.mesh import AXIS_DATA, build_mesh
from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
from video_super_resolution_tpu_torch.training.state import create_train_state
from video_super_resolution_tpu_torch.training.step import make_train_step
from video_super_resolution_tpu_torch.utils.logging import MetricsLogger, is_host0


def make_batch_stream(cfg: VSRConfig, train_ds: ClipDataset,
                      batch_size: Optional[int] = None,
                      seed: Optional[int] = None
                      ) -> Tuple[Iterator[dict], Callable[[], None], str]:
    """(batches, close, "native" | "python"): the native loader for a
    path-backed HR-only dataset when it can be built, else the dataset's
    own batches; ``batch_size`` samples a batch (default
    ``cfg.data.batch_size``). With ``seed``, the stream is drawn from that
    seed (the dataset's RNG is reseeded) instead of ``cfg.train.seed``
    and the dataset's own RNG."""
    batch_size = batch_size or cfg.data.batch_size
    if (train_ds._paths_hr is not None and train_ds._paths_lr is None
            and native_loader.available()):
        loader = native_loader.NativeClipLoader(
            train_ds._paths_hr, window=cfg.model.window,
            scale=cfg.model.scale, crop_size=cfg.data.crop_size,
            batch_size=batch_size, augment=cfg.data.augment,
            seed=cfg.train.seed if seed is None else seed)
        return loader, loader.close, "native"
    if seed is not None:
        train_ds.rng = np.random.default_rng(seed)
    return train_ds.batches(batch_size), (lambda: None), "python"


def compact_batches(batches: Iterator[dict]) -> Iterator[dict]:
    """HR f32 -> uint8 (round(255 x), exact for 8-bit sources), LR f32 ->
    bf16: 3.3x fewer bytes to the device; ``training.step.decode_batch``
    turns them back into f32."""
    for b in batches:
        yield {"lr": torch.from_numpy(b["lr"]).to(torch.bfloat16),
               "hr": torch.from_numpy(
                   np.round(b["hr"] * 255.0).astype(np.uint8))}


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
    mesh = build_mesh(cfg.mesh, dev) if cfg.mesh.num_devices > 1 else None
    batch_size, seed = cfg.data.batch_size, None
    if mesh is not None:
        n = mesh.size(AXIS_DATA)
        if batch_size % n:
            raise ValueError(f"batch {batch_size} not divisible by the data "
                             f"axis {n}")
        batch_size, seed = batch_size // n, cfg.train.seed + mesh.index(AXIS_DATA)
    step_fn = make_train_step(cfg.train.charbonnier_eps, mesh=mesh)
    state = create_train_state(cfg, dev)
    mgr = CheckpointManager(cfg.train.ckpt_dir, keep=cfg.train.keep_ckpts)
    mgr.restore(state)
    start_step = state.step
    host0 = is_host0()

    logger = MetricsLogger(cfg.train.ckpt_dir, "train")
    raw, close_loader, loader_name = make_batch_stream(cfg, train_ds,
                                                       batch_size, seed)
    if (loader_name == "native" and cfg.train.compute_dtype == "bfloat16"
            and os.environ.get("VSR_COMPACT_TRANSFER", "1") == "1"):
        raw = compact_batches(raw)
    batches = device_prefetch(raw, dev)
    logger.log(start_step, {"native_loader": float(loader_name == "native")})
    last_eval: Dict = {}
    t_last = time.time()
    try:
        for step in range(start_step, steps):
            state, metrics = step_fn(state, next(batches))

            if (step + 1) % cfg.train.log_every == 0:
                vals = {k: float(v) for k, v in metrics.items()}   # waits
                now = time.time()
                sps = cfg.train.log_every / (now - t_last)
                t_last = now
                logger.log(step + 1, {**vals, "steps_per_s": sps,
                                      "frames_per_s": sps * cfg.data.batch_size})
            if host0 and ((step + 1) % cfg.train.ckpt_every == 0
                          or step + 1 == steps):
                mgr.save(step + 1, state, cfg)
            if (host0 and eval_ds is not None and eval_every
                    and (step + 1) % eval_every == 0):
                last_eval = evaluate_all(
                    api.eval_step, state.model, eval_ds,
                    cfg.data.y_channel_eval, cfg.data.border_crop)
                # the training steps that follow need the graphs' pool
                api.release_graphs(state.model)
                avg = last_eval["__average__"]
                logger.log(step + 1, {"eval_psnr": avg["psnr"],
                                      "eval_ssim": avg["ssim"]},
                           prefix="eval/")
    finally:
        close_loader()
        mgr.wait()
        logger.close()
    return {"state": state, "eval": last_eval, "ckpt": mgr}

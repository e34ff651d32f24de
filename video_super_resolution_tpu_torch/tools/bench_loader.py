"""The training input path's number, the port's counterpart of the JAX
package's ``tools/bench_loader.py``.

    python -m video_super_resolution_tpu_torch.tools.bench_loader \\
        [--loader {native,python}] [--warmup 400 --steps 1000] \\
        [--root DIR] [--out FILE] [--device cpu]

Writes the PNG clips (``make_png_clips``: six clips of 16 frames of
384x512, the JAX tool's draws), then at ``VSRConfig()`` (batch 4, LR crop
64, window 3, bf16, seeded random weights) measures:

- ``loader_batches_per_s``: 200 batches of the stream after 10, no model
  (the JAX tool's counts; ``run``'s caller may set others);
- ``host_driven_steps_per_s`` (and ``host_driven_frames_per_s``, x batch):
  the train step fed by the stream through ``training.loop.device_prefetch``,
  ``--steps`` steps after ``--warmup`` (``warmup_s``), one sync at the end
  (``loss.item()``);
- ``device_side_steps_per_s``: the same step on a constant batch on the
  device, ``--steps`` steps, over the device's profiled busy seconds
  (``bench_dispatch.device_side``), and the two ratios to it.

Two departures from the JAX tool:

- The device-side bound is this card's, measured in this process on the
  same config; the JAX tool read ``bench_baseline.json``, a TPU figure.
  ``loader_vs_device_side`` and ``ratio_vs_device_side`` divide by it.
- ``--loader``: ``native`` (the default) raises when the stream does not
  engage the native C++ loader, naming what ``native_loader.missing()``
  reports (it needs g++ alone), as the JAX tool asserts it; ``python``
  measures ``ClipDataset``'s own batches, the control, asked for
  explicitly, never as a silent fallback. ``VSR_LOADER_CACHE_MB=0`` in
  the environment turns the native loader's frame cache off, so every
  sample decodes and degrades (cold).

``device``: the card's ``nvidia-smi`` name and power limit, or "cpu".
Writes ``artifacts/BENCH_loader_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.data import native_loader
from video_super_resolution_tpu_torch.data.dataset import ClipDataset
from video_super_resolution_tpu_torch.data.synthetic import moving_gradient_clip
from video_super_resolution_tpu_torch.tools.bench_dispatch import (
    DEFAULT_ROOT,
    REPO,
    constant_batch,
    device_record,
    device_side,
    write_record,
)
from video_super_resolution_tpu_torch.training.loop import device_prefetch, make_batch_stream
from video_super_resolution_tpu_torch.training.state import create_train_state
from video_super_resolution_tpu_torch.training.step import make_train_step

LOADERS = ("native", "python")
LOADER_BATCHES = (10, 200)      # the loader alone: skipped, then timed (JAX's)


def make_png_clips(root: str, n_clips: int = 6, frames: int = 16,
                   h: int = 384, w: int = 512) -> None:
    """clip{i}/{t:04d}.png under ``root``: the JAX tool's clips
    (``default_rng(7)`` shifts, ``moving_gradient_clip`` seeds 500 + i,
    rounded to uint8); a clip directory that already holds ``frames``
    files is kept."""
    from PIL import Image

    rng = np.random.default_rng(7)
    for i in range(n_clips):
        d = os.path.join(root, f"clip{i}")
        if os.path.isdir(d) and len(os.listdir(d)) == frames:
            continue
        os.makedirs(d, exist_ok=True)
        dx = float(rng.uniform(-4, 4))
        dy = float(rng.uniform(-4, 4))
        hr, _ = moving_gradient_clip(frames, h, w, dx, dy, seed=500 + i)
        for t in range(frames):
            img = Image.fromarray(
                (np.clip(hr[t], 0, 1) * 255).round().astype(np.uint8))
            img.save(os.path.join(d, f"{t:04d}.png"))


def batch_stream(cfg: VSRConfig, ds: ClipDataset, loader: str
                 ) -> Tuple[Iterator[dict], Callable[[], None], str]:
    """The stream ``loader`` names: the production stream, which must have
    engaged the native loader, or the dataset's own batches."""
    if loader == "python":
        return ds.batches(cfg.data.batch_size), (lambda: None), "python"
    if loader != "native":
        raise ValueError(f"loader {loader!r} not in {LOADERS}")
    raw, close, name = make_batch_stream(cfg, ds)
    if name != "native":
        close()
        missing = native_loader.missing()
        raise RuntimeError(
            f"native loader not engaged ({name}): native_loader.missing() "
            f"reports {', '.join(missing) if missing else 'nothing'}; "
            f"--loader python measures the Python loader")
    return raw, close, name


def run(loader: str = "native", warmup: int = 400, steps: int = 1000,
        root: str = DEFAULT_ROOT, device: api.Device = "cuda",
        cfg: Optional[VSRConfig] = None, clips: Optional[dict] = None,
        out: Optional[str] = None,
        loader_batches: Tuple[int, int] = LOADER_BATCHES,
        emit: Callable[[str], None] = print) -> dict:
    """The record at ``cfg`` (default ``VSRConfig()``) on PNG clips under
    ``root`` (``make_png_clips(root, **clips)``), the loader alone timed
    over ``loader_batches`` (skipped, timed); written to ``out`` when
    given, and returned."""
    dev = api.resolve_device(device)
    cfg = cfg or VSRConfig()
    clips = {"n_clips": 6, "frames": 16, "h": 384, "w": 512, **(clips or {})}
    make_png_clips(root, **clips)
    ds = ClipDataset(hr_root=root, window=cfg.model.window,
                     scale=cfg.model.scale, crop_size=cfg.data.crop_size,
                     augment=True, seed=0)
    state = create_train_state(cfg, dev)
    step_fn = make_train_step(cfg.train.charbonnier_eps)
    raw, close, name = batch_stream(cfg, ds, loader)
    try:
        batches = device_prefetch(raw, dev)
        it = iter(raw)          # the loader alone first: no model
        skip, timed = loader_batches
        for _ in range(skip):
            next(it)
        t0 = time.perf_counter()
        for _ in range(timed):
            next(it)
        loader_bps = timed / (time.perf_counter() - t0)

        t0 = time.perf_counter()
        for _ in range(warmup):
            state, m = step_fn(state, next(batches))
        m["loss"].item()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step_fn(state, next(batches))
        loss = m["loss"].item()     # one sync: the steps chain through state
        host_sps = steps / (time.perf_counter() - t0)
    finally:
        close()
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    dev_sps = device_side(state, step_fn, constant_batch(cfg, dev), steps,
                          dev)["device_side_steps_per_s"]
    rec = {
        "loader": name,
        "loader_batches_per_s": loader_bps,
        "loader_vs_device_side": loader_bps / dev_sps,
        "note": ("loader_batches_per_s is the input pipeline alone (PNG "
                 "decode and bicubic degrade, then crops; no model); "
                 "host_driven_steps_per_s is the train step fed by it; "
                 "device_side_steps_per_s is this card's bound for the same "
                 "step, measured in this process as steps over the "
                 "profiled device busy seconds on a constant batch"),
        "host_driven_steps_per_s": host_sps,
        "host_driven_frames_per_s": host_sps * cfg.data.batch_size,
        "device_side_steps_per_s": dev_sps,
        "ratio_vs_device_side": host_sps / dev_sps,
        "batch": cfg.data.batch_size,
        "crop": cfg.data.crop_size,
        "warmup_s": warm_s,
        "steps": steps,
        "device": device_record(dev),
        "clips": (f"{clips['n_clips']}x{clips['frames']} PNG frames "
                  f"{clips['h']}x{clips['w']} (moving_gradient_clip)"),
    }
    write_record(out, rec)
    emit(json.dumps(rec))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loader", choices=LOADERS, default="native")
    ap.add_argument("--root", default=DEFAULT_ROOT, help="PNG clips")
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default=os.path.join(
        REPO, "artifacts", "BENCH_loader_torch.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.loader, args.warmup, args.steps, args.root, args.device,
        out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

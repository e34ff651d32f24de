"""Clip evaluation loop: sliding windows -> PSNR/SSIM.

Windows go through the eval step in groups of ``batch_windows``; metrics
are computed on the host in numpy, per-clip averages follow the Vid4/REDS4
protocol with the Y-channel + border-crop conventions of ``DataConfig``.
The last partial group is padded by repeating its final window and the
padded outputs are discarded, as in the JAX package's
``evaluation/evaluate.py``.

``eval_step(model, lr)`` is ``api.eval_step``: an (N, T, h, w, 3) tensor in,
the f32 prediction clipped to [0, 1] out.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from video_super_resolution_tpu_torch.data.dataset import ClipDataset
from video_super_resolution_tpu_torch.evaluation.metrics import psnr, ssim


def evaluate_clip(
    eval_step: Callable,
    model,
    dataset: ClipDataset,
    clip: str,
    y_channel: bool = True,
    border_crop: int = 4,
    batch_windows: int = 4,
) -> Dict[str, float]:
    """Average PSNR/SSIM over all frames of one clip."""
    psnrs, ssims = [], []
    buf_lr, buf_hr = [], []

    def flush():
        n = len(buf_lr)
        if not n:
            return
        lr = np.concatenate(buf_lr)
        if n < batch_windows:
            lr = np.concatenate([lr] + [lr[-1:]] * (batch_windows - n))
        pred = eval_step(model, torch.from_numpy(lr)).cpu().numpy()
        for i in range(n):
            psnrs.append(psnr(pred[i], buf_hr[i], y_channel, border_crop))
            ssims.append(ssim(pred[i], buf_hr[i], y_channel, border_crop))
        buf_lr.clear()
        buf_hr.clear()

    for batch in dataset.eval_windows(clip):
        buf_lr.append(batch["lr"])
        buf_hr.append(batch["hr"][0])
        if len(buf_lr) == batch_windows:
            flush()
    flush()
    return {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "frames": len(psnrs),
    }


def evaluate_all(
    eval_step: Callable, model, dataset: ClipDataset,
    y_channel: bool = True, border_crop: int = 4,
    batch_windows: int = 4,
) -> Dict[str, Dict[str, float]]:
    results = {}
    for clip in dataset.clip_names:
        results[clip] = evaluate_clip(
            eval_step, model, dataset, clip, y_channel, border_crop,
            batch_windows,
        )
    avg_p = float(np.mean([r["psnr"] for r in results.values()]))
    avg_s = float(np.mean([r["ssim"] for r in results.values()]))
    results["__average__"] = {"psnr": avg_p, "ssim": avg_s,
                              "frames": sum(r["frames"] for r in results.values())}
    return results

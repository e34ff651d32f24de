"""The port's entry points that the kinds call, and what the serving
kinds share: the model built as users build it, with the benchmark's
weights; the port's kernel launch counters; and the comparison of served
HR frames with the reference's."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.ops.correlation import correlation
from video_super_resolution_tpu_torch.ops.fused_conv import fused_conv3x3
from video_super_resolution_tpu_torch.ops.warp import backward_warp
from vsr_bench import weights


def vsr_config(run) -> VSRConfig:
    return VSRConfig.from_dict(run.config["vsr_config"])


def serving_model(run):
    """``api.build_model`` of the cell's configuration on the run's device,
    with the benchmark's weights loaded before its first forward."""
    model = api.build_model(vsr_config(run), run.device)
    weights.load(model, run.weights)
    return model


def launches() -> Dict[str, int]:
    """Each port kernel wrapper's count of launches."""
    return {"conv3x3": fused_conv3x3.launches,
            "correlation": correlation.launches,
            "warp": backward_warp.launches}


def control_upscale(run, window: np.ndarray) -> np.ndarray:
    """The control in the port's place: the run's reference at fp8, the
    next precision below the configuration's bf16, clipped as
    ``eval_step`` clips. window (1, T, h, w, 3) -> (sH, sW, 3)."""
    ref = run.reference
    with torch.no_grad():
        x = torch.as_tensor(window).to(run.device)
        out = ref.forward(run.weights, run.model, x,
                          ref.Ops(quant=torch.float8_e4m3fn))
        return out[0].clamp(0.0, 1.0).cpu().numpy()


def no_tf32():
    """The reference's f32 is f32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compare_frames(run, served: Sequence[np.ndarray],
                   windows: Sequence[np.ndarray], limits: dict) -> dict:
    """The worst, over the served HR frames, of the root mean square and of
    the largest absolute difference from the run's reference's frame of
    the same window (f32, clipped to [0, 1]), each beside its limit."""
    no_tf32()
    rms: List[float] = []
    top: List[float] = []
    with torch.no_grad():
        for hr, window in zip(served, windows):
            x = torch.as_tensor(window).to(run.device)
            ref = run.reference.forward(run.weights, run.model, x)
            ref = ref[0].clamp(0, 1)
            d = torch.as_tensor(hr).to(run.device) - ref
            rms.append(float(d.square().mean().sqrt()))
            top.append(float(d.abs().max()))
            del ref, d, x
    nums = {"hr_rms": max(rms) if rms else float("nan"),
            "hr_max": max(top) if top else float("nan")}
    return {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}

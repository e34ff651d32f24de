"""LR degradation: MATLAB-style antialiased bicubic x1/scale downscale.

The VSR-dataset convention (Vid4/REDS LR generation) is MATLAB ``imresize``:
cubic a=-0.5, antialias, border-replicate accumulation, through the port's
separable ``resize_bicubic``. It runs on the host CPU inside the data
pipeline, numpy in and out, as the JAX package's ``data/degrade.py`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from video_super_resolution_tpu_torch.ops.resize import resize_bicubic


def degrade_bicubic(hr: np.ndarray, scale: int) -> np.ndarray:
    """(..., H, W, 3) [0,1] -> (..., H/scale, W/scale, 3), MATLAB preset."""
    h, w = hr.shape[-3], hr.shape[-2]
    if h % scale or w % scale:
        raise ValueError(f"HR dims ({h},{w}) not divisible by scale {scale}")
    with torch.no_grad():
        out = resize_bicubic(
            torch.from_numpy(np.ascontiguousarray(hr, np.float32)),
            h // scale, w // scale)
    return np.clip(out.numpy(), 0.0, 1.0)

"""Local cost-volume correlation between two NHWC feature maps.

    cost[b, y, x, k] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]

with k row-major over (dy, dx) in [-d, d]^2 and f2 zero outside the image;
f32 output and accumulation. ``correlation`` launches the CUDA kernel
``csrc/correlation.cu`` for CUDA tensors and runs ``correlation_plain``,
the shifted-slice formulation of the JAX package, for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from video_super_resolution_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 4   # displacement radii compiled into the kernel: 1..4


def _check(f1, f2, d):
    if f1.shape != f2.shape or f1.ndim != 4:
        raise ValueError(f"correlation: shapes {tuple(f1.shape)} vs "
                         f"{tuple(f2.shape)} must be equal NHWC")
    if d < 1:
        raise ValueError(f"correlation: max_displacement {d} < 1")


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor,
                      max_displacement: int = 4) -> torch.Tensor:
    """Plain PyTorch version: one f32 product-sum per displacement."""
    _check(f1, f2, max_displacement)
    d = max_displacement
    b, h, w, c = f1.shape
    f2p = F.pad(f2.to(torch.float32), (0, 0, d, d, d, d))
    a = f1.to(torch.float32)
    inv_c = 1.0 / c
    planes = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            win = f2p[:, d + dy:d + dy + h, d + dx:d + dx + w, :]
            planes.append((a * win).sum(dim=-1) * inv_c)
    return torch.stack(planes, dim=-1)


def _correlation_cuda(f1, f2, d):
    _check(f1, f2, d)
    _build.require_cuda("correlation", f1, f2)
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise TypeError(f"correlation: dtypes {f1.dtype}/{f2.dtype}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation: inputs must be contiguous NHWC")
    if d > MAX_D:
        raise ValueError(f"correlation: kernel takes d <= {MAX_D}, got {d}")
    b, h, w, c = f1.shape
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=torch.float32,
                      device=f1.device)
    lib = _build.lib()
    with torch.cuda.device(f1.device):
        rc = lib.vsr_correlation(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, d,
            int(f1.dtype == torch.bfloat16), _build.stream_of(f1))
    _build.check_launch("correlation", rc)
    correlation.launches += 1
    return out


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H, W, (2d+1)^2) f32 cost volume."""
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, max_displacement)
    return _correlation_cuda(f1, f2, max_displacement)


correlation.launches = 0

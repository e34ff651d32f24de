"""Local cost-volume correlation between two NHWC feature maps.

    cost[b, y, x, k] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]

with k row-major over (dy, dx) in [-d, d]^2 and f2 zero outside the image,
f32 accumulation; then, optionally, a LeakyReLU of the f32 result and a
cast to ``out_dtype`` (f32 by default), which is the flow net's
``lrelu(correlation(...)).astype(dtype)``. ``correlation`` launches the
CUDA kernel ``csrc/correlation.cu`` for CUDA tensors and runs
``correlation_plain``, the shifted-slice formulation of the JAX package,
for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from video_super_resolution_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 4   # displacement radii compiled into the kernel: 1..4


def _check(f1, f2, d, out_dtype):
    if f1.shape != f2.shape or f1.ndim != 4:
        raise ValueError(f"correlation: shapes {tuple(f1.shape)} vs "
                         f"{tuple(f2.shape)} must be equal NHWC")
    if d < 1:
        raise ValueError(f"correlation: max_displacement {d} < 1")
    if out_dtype not in _DTYPES:
        raise TypeError(f"correlation: out_dtype {out_dtype} not in {_DTYPES}")


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor,
                      max_displacement: int = 4, slope: Optional[float] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: one f32 product-sum per displacement, then
    the LeakyReLU in f32 (when ``slope`` is given) and the cast."""
    _check(f1, f2, max_displacement, out_dtype)
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
    out = torch.stack(planes, dim=-1)
    if slope is not None:
        out = F.leaky_relu(out, slope)
    return out.to(out_dtype)


def _correlation_cuda(f1, f2, d, slope, out_dtype):
    _check(f1, f2, d, out_dtype)
    _build.require_cuda("correlation", f1, f2)
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise TypeError(f"correlation: dtypes {f1.dtype}/{f2.dtype}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation: inputs must be contiguous NHWC")
    if d > MAX_D:
        raise ValueError(f"correlation: kernel takes d <= {MAX_D}, got {d}")
    b, h, w, c = f1.shape
    out = torch.empty((b, h, w, (2 * d + 1) ** 2), dtype=out_dtype,
                      device=f1.device)
    lib = _build.lib()
    with torch.cuda.device(f1.device):
        rc = lib.vsr_correlation(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c, d,
            int(f1.dtype == torch.bfloat16),
            0.0 if slope is None else float(slope), int(slope is not None),
            int(out_dtype == torch.bfloat16), _build.stream_of(f1))
    _build.check_launch("correlation", rc)
    correlation.launches += 1
    return out


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 4,
                slope: Optional[float] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H, W, (2d+1)^2) cost volume in out_dtype,
    LeakyReLU'd with ``slope`` when it is given."""
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, max_displacement, slope, out_dtype)
    return _correlation_cuda(f1, f2, max_displacement, slope, out_dtype)


correlation.launches = 0

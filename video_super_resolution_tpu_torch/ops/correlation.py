"""Local cost-volume correlation between two NHWC feature maps.

    cost[b, y, x, k] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]

with k row-major over (dy, dx) in [-d, d]^2 and f2 zero outside the image,
f32 accumulation; then, optionally, a LeakyReLU of the f32 result and a
cast to ``out_dtype`` (f32 by default), which is the flow net's
``lrelu(correlation(...)).astype(dtype)``. ``correlation`` launches the
CUDA kernel ``csrc/correlation.cu`` for CUDA tensors and runs
``correlation_plain``, the shifted-slice formulation of the JAX package,
for CPU tensors.

Gradients: with grad enabled and an input that requires it, the forward
runs inside ``_CorrelationFn`` and ``correlation_backward`` gives d f1 and
d f2, the counterpart of the JAX package's ``correlation_pallas`` backward
(XLA's vjp of the plain formulation, not a Pallas kernel).
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


def correlation_backward(g: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                         max_displacement: int = 4,
                         slope: Optional[float] = None,
                         out: Optional[torch.Tensor] = None):
    """(d f1, d f2) of ``correlation`` from the output's gradient ``g`` (and,
    with a ``slope``, the saved output ``out``, whose sign is that of the
    LeakyReLU's input), in f32, returned in the inputs' dtypes:

        d f1[p]  = (1/C) sum_k g'[p, k] f2[p + s_k]
        d f2[q]  = (1/C) sum_k g'[q - s_k, k] f1[q - s_k]

    with s_k the k-th (dy, dx) shift and f2 zero outside the image. The
    shifted windows of f2 are one ``unfold`` (im2col with zero padding d,
    row-major over (dy, dx) like k), the scatter back onto f2 one ``fold``
    (its adjoint); levels smaller than the window read the zero padding."""
    d = max_displacement
    b, h, w, c = f1.shape
    k = 2 * d + 1
    gc = g.to(torch.float32)
    if slope is not None:
        gc = torch.where(out >= 0, gc, gc * slope)
    gc = (gc * (1.0 / c)).permute(0, 3, 1, 2).reshape(b, 1, k * k, h * w)
    f2n = f2.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    win = F.unfold(f2n, k, padding=d).view(b, c, k * k, h * w)
    df1 = (win * gc).sum(dim=2).view(b, c, h, w)
    a = f1.to(torch.float32).permute(0, 3, 1, 2).reshape(b, c, 1, h * w)
    df2 = F.fold((a * gc).view(b, c * k * k, h * w), (h, w), k, padding=d)
    return (df1.permute(0, 2, 3, 1).to(f1.dtype).contiguous(),
            df2.permute(0, 2, 3, 1).to(f2.dtype).contiguous())


def _correlation_forward(f1, f2, d, slope, out_dtype):
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, d, slope, out_dtype)
    return _correlation_cuda(f1, f2, d, slope, out_dtype)


class _CorrelationFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f1, f2, d, slope, out_dtype):
        out = _correlation_forward(f1, f2, d, slope, out_dtype)
        ctx.save_for_backward(f1, f2, out if slope is not None else None)
        ctx.conf = (d, slope)
        return out

    @staticmethod
    def backward(ctx, g):
        f1, f2, out = ctx.saved_tensors
        df1, df2 = correlation_backward(g, f1, f2, *ctx.conf, out)
        return df1, df2, None, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 4,
                slope: Optional[float] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) x 2 -> (B, H, W, (2d+1)^2) cost volume in out_dtype,
    LeakyReLU'd with ``slope`` when it is given. Differentiable in f1, f2."""
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return _CorrelationFn.apply(f1, f2, max_displacement, slope,
                                    out_dtype)
    return _correlation_forward(f1, f2, max_displacement, slope, out_dtype)


correlation.launches = 0

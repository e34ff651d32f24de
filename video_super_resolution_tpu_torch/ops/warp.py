"""Flow-guided bilinear backward warp: out(x) = img(x + flow(x)).

Pixel-space flow (``flow[..., 0]`` along W, ``flow[..., 1]`` along H),
align-corners pixel taps, "zeros" or "border" padding, f32 weights, output
in img's dtype. ``backward_warp`` launches the CUDA kernel ``csrc/warp.cu``
for CUDA tensors and runs ``warp_plain``, the exact 4-tap gather of the JAX
package's ``_warp_xla``, for CPU tensors. Exact for any flow and any C.
"""

from __future__ import annotations

import torch

from video_super_resolution_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)
_MODES = ("zeros", "border")
# 256 threads a pixel, each one 16-byte channel group
MAX_C = {torch.float32: 1024, torch.bfloat16: 2048}


def _check(img, flow, padding_mode):
    if padding_mode not in _MODES:
        raise ValueError(f"backward_warp: bad padding_mode {padding_mode}")
    if img.ndim != 4 or tuple(flow.shape) != (*img.shape[:3], 2):
        raise ValueError(f"backward_warp: img {tuple(img.shape)} / flow "
                         f"{tuple(flow.shape)} must be (B,H,W,C) / (B,H,W,2)")


def warp_plain(img: torch.Tensor, flow: torch.Tensor,
               padding_mode: str = "zeros") -> torch.Tensor:
    """Plain PyTorch version: gather the 4 taps, blend in f32."""
    _check(img, flow, padding_mode)
    b, h, w, c = img.shape
    dev = img.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    sx = xs[None] + flow[..., 0].to(torch.float32)
    sy = ys[None] + flow[..., 1].to(torch.float32)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    flat = img.reshape(b, h * w, c)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = xi.clamp(0, w - 1).to(torch.int64)
        yc = yi.clamp(0, h - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(b, h * w, 1).expand(b, h * w, c)
        g = torch.gather(flat, 1, idx).reshape(b, h, w, c).to(torch.float32)
        if padding_mode == "zeros":
            g = torch.where(valid[..., None], g, torch.zeros((), device=dev))
        return g

    t00 = tap(y0, x0)
    t01 = tap(y0, x0 + 1)
    t10 = tap(y0 + 1, x0)
    t11 = tap(y0 + 1, x0 + 1)
    w00 = ((1 - wy) * (1 - wx))[..., None]
    w01 = ((1 - wy) * wx)[..., None]
    w10 = (wy * (1 - wx))[..., None]
    w11 = (wy * wx)[..., None]
    out = w00 * t00 + w01 * t01 + w10 * t10 + w11 * t11
    return out.to(img.dtype)


def _warp_cuda(img, flow, padding_mode):
    _check(img, flow, padding_mode)
    _build.require_cuda("backward_warp", img, flow)
    if img.dtype not in _DTYPES or flow.dtype != torch.float32:
        raise TypeError(f"backward_warp: img {img.dtype} must be f32/bf16 "
                        f"and flow {flow.dtype} f32")
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError("backward_warp: inputs must be contiguous")
    b, h, w, c = img.shape
    if c > MAX_C[img.dtype] or h > 65535 or b > 65535:
        raise ValueError(f"backward_warp: kernel takes C <= "
                         f"{MAX_C[img.dtype]}, H and B <= 65535, got "
                         f"{tuple(img.shape)}")
    out = torch.empty_like(img)
    lib = _build.lib()
    with torch.cuda.device(img.device):
        rc = lib.vsr_warp(
            img.data_ptr(), flow.data_ptr(), out.data_ptr(), b, h, w, c,
            int(padding_mode == "zeros"), int(img.dtype == torch.bfloat16),
            _build.stream_of(img))
    _build.check_launch("warp", rc)
    backward_warp.launches += 1
    return out


def backward_warp(img: torch.Tensor, flow: torch.Tensor,
                  padding_mode: str = "zeros") -> torch.Tensor:
    """img (B, H, W, C), flow (B, H, W, 2) pixels -> (B, H, W, C)."""
    if img.device.type == "cpu":
        return warp_plain(img, flow, padding_mode)
    return _warp_cuda(img, flow, padding_mode)


backward_warp.launches = 0

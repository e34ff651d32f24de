"""Flow-guided bilinear backward warp: out(x) = img(x + flow(x)).

Pixel-space flow (``flow[..., 0]`` along W, ``flow[..., 1]`` along H),
align-corners pixel taps, "zeros" or "border" padding, f32 weights, output
in img's dtype. ``backward_warp`` launches the CUDA kernel ``csrc/warp.cu``
for CUDA tensors and runs ``warp_plain``, the exact 4-tap gather of the JAX
package's ``_warp_xla``, for CPU tensors. Exact for any flow and any C.

Gradients: with grad enabled and an input that requires it, the forward
runs inside ``_WarpFn`` and ``warp_backward`` gives d img and d flow, as
JAX's autodiff of ``_warp_xla`` does (the TPU kernel's own backward
differentiates another formulation, ``warp_tiled``, which clamps far
taps).
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


def _tap_coords(flow, h, w):
    """Sample position of each pixel: (x0, y0, wx, wy), f32 (B, H, W)."""
    dev = flow.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    sx = xs[None] + flow[..., 0].to(torch.float32)
    sy = ys[None] + flow[..., 1].to(torch.float32)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    return x0, y0, sx - x0, sy - y0


def warp_plain(img: torch.Tensor, flow: torch.Tensor,
               padding_mode: str = "zeros") -> torch.Tensor:
    """Plain PyTorch version: gather the 4 taps, blend in f32."""
    _check(img, flow, padding_mode)
    b, h, w, c = img.shape
    dev = img.device
    x0, y0, wx, wy = _tap_coords(flow, h, w)
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


def warp_backward(g: torch.Tensor, img: torch.Tensor, flow: torch.Tensor,
                  padding_mode: str = "zeros", needs=(True, True)):
    """(d img, d flow) of ``backward_warp`` from the output's gradient g,
    each None where ``needs`` says so.

    d img is a scatter-add (``index_add_``, f32) of each of the four taps'
    weight x g onto its clamped source pixel (zeros mode: in-bounds taps
    only), cast to img's dtype. d flow is f32, through the bilinear weights:
    the tap positions (floor) carry no gradient, so d/d flow_x is d/d wx,
    sum_c g * ((1 - wy)(t01 - t00) + wy (t11 - t10)), and likewise for y."""
    b, h, w, c = img.shape
    x0, y0, wx, wy = _tap_coords(flow, h, w)
    gf = g.to(torch.float32)
    flat = img.reshape(b * h * w, c)
    base = (torch.arange(b, device=img.device) * (h * w)).view(b, 1, 1)
    dimg = torch.zeros((b * h * w, c), dtype=torch.float32,
                       device=img.device) if needs[0] else None
    dwx = dwy = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yi, xi = y0 + dy, x0 + dx
            idx = (base + yi.clamp(0, h - 1).to(torch.int64) * w
                   + xi.clamp(0, w - 1).to(torch.int64)).reshape(-1)
            ky = wy if dy else 1 - wy
            kx = wx if dx else 1 - wx
            if padding_mode == "zeros":
                valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0)
                         & (yi <= h - 1)).to(torch.float32)
                ky, kx = ky * valid, kx * valid
            if dimg is not None:
                dimg.index_add_(0, idx, (gf * (ky * kx)[..., None])
                                .reshape(-1, c))
            if needs[1]:
                s = (gf * flat.index_select(0, idx).reshape(b, h, w, c)
                     .to(torch.float32)).sum(dim=-1)
                dwx = dwx + s * (ky if dx else -ky)
                dwy = dwy + s * (kx if dy else -kx)
    dflow = torch.stack([dwx, dwy], dim=-1).to(flow.dtype) if needs[1] else None
    return (dimg.reshape(b, h, w, c).to(img.dtype) if needs[0] else None,
            dflow)


def _warp_forward(img, flow, padding_mode):
    if img.device.type == "cpu":
        return warp_plain(img, flow, padding_mode)
    return _warp_cuda(img, flow, padding_mode)


class _WarpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, flow, padding_mode):
        ctx.save_for_backward(img, flow)
        ctx.padding_mode = padding_mode
        return _warp_forward(img, flow, padding_mode)

    @staticmethod
    def backward(ctx, g):
        img, flow = ctx.saved_tensors
        dimg, dflow = warp_backward(g, img, flow, ctx.padding_mode,
                                    ctx.needs_input_grad[:2])
        return dimg, dflow, None


def backward_warp(img: torch.Tensor, flow: torch.Tensor,
                  padding_mode: str = "zeros") -> torch.Tensor:
    """img (B, H, W, C), flow (B, H, W, 2) pixels -> (B, H, W, C).
    Differentiable in img and flow."""
    if torch.is_grad_enabled() and (img.requires_grad or flow.requires_grad):
        return _WarpFn.apply(img, flow, padding_mode)
    return _warp_forward(img, flow, padding_mode)


backward_warp.launches = 0

"""Fused 3x3 conv + bias (+ residual) + LeakyReLU on NHWC activations.

``fused_conv3x3`` launches the CUDA kernel ``csrc/conv3x3.cu`` for CUDA
tensors and runs ``conv3x3_plain``, the same function in plain PyTorch, for
CPU tensors. It is the port of the JAX package's ``fused_conv3x3`` and of
the math of ``fused_conv3x3_packed`` (whose pixel-pair layout only served
the TPU): every stride-1 3x3 conv of the model, any dilation and any Cin.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from video_super_resolution_tpu_torch.ops import _build
from video_super_resolution_tpu_torch.ops.pixel_shuffle import pixel_shuffle

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, w, b, res, res_repeat, dilation):
    if x.ndim != 4 or w.ndim != 4 or w.shape[2:] != (3, 3):
        raise ValueError(f"fused_conv3x3: x {tuple(x.shape)} must be NHWC and "
                         f"w {tuple(w.shape)} OIHW 3x3")
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    if w.shape[1] != cin or b.shape != (cout,):
        raise ValueError(f"fused_conv3x3: w {tuple(w.shape)} / b "
                         f"{tuple(b.shape)} do not fit cin={cin}")
    if dilation < 1 or res_repeat < 1:
        raise ValueError("fused_conv3x3: dilation and res_repeat must be >= 1")
    if res is not None:
        if bsz % res_repeat:
            raise ValueError(f"fused_conv3x3: batch {bsz} not divisible by "
                             f"res_repeat {res_repeat}")
        want = (bsz // res_repeat, h, wd, cout)
        if tuple(res.shape) != want:
            raise ValueError(f"fused_conv3x3: res {tuple(res.shape)} != {want}")


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  slope: float = 0.1, dilation: int = 1,
                  res: Optional[torch.Tensor] = None,
                  res_repeat: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel: conv of the input values with
    f32 accumulation, + bias (+ res broadcast over groups of ``res_repeat``
    batch items), LeakyReLU, one rounding to x's dtype."""
    _check(x, w, b, res, res_repeat, dilation)
    xf = x.permute(0, 3, 1, 2).to(torch.float32)
    out = F.conv2d(xf, w.to(x.dtype).to(torch.float32), None,
                   padding=dilation, dilation=dilation)
    out = out.permute(0, 2, 3, 1) + b.to(torch.float32)
    if res is not None:
        out = out + torch.repeat_interleave(res.to(torch.float32),
                                            res_repeat, dim=0)
    out = torch.where(out >= 0, out, slope * out)
    return out.to(x.dtype).contiguous()


def _conv3x3_cuda(x, w, b, slope, dilation, res, res_repeat):
    _check(x, w, b, res, res_repeat, dilation)
    tensors = [x, w, b] + ([res] if res is not None else [])
    _build.require_cuda("fused_conv3x3", *tensors)
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_conv3x3: dtype {x.dtype} not in {_DTYPES}")
    if not x.is_contiguous():
        raise ValueError("fused_conv3x3: x must be contiguous NHWC")
    if res is not None:
        if res.dtype not in (x.dtype, torch.float32):
            raise TypeError(f"fused_conv3x3: res dtype {res.dtype}")
        if not res.is_contiguous():
            raise ValueError("fused_conv3x3: res must be contiguous")
    bsz, h, wd, cin = x.shape
    cout = w.shape[0]
    w_hwio = w.to(x.dtype).permute(2, 3, 1, 0).contiguous()
    bias = b.to(torch.float32).contiguous()
    out = torch.empty((bsz, h, wd, cout), dtype=x.dtype, device=x.device)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        rc = lib.vsr_conv3x3(
            x.data_ptr(), w_hwio.data_ptr(), bias.data_ptr(),
            res.data_ptr() if res is not None else None, out.data_ptr(),
            bsz, h, wd, cin, cout, dilation, float(slope), res_repeat,
            int(res is not None and res.dtype == torch.float32),
            int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check_launch("conv3x3", rc)
    fused_conv3x3.launches += 1
    return out


def fused_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  slope: float = 0.1, dilation: int = 1,
                  res: Optional[torch.Tensor] = None, res_repeat: int = 1,
                  shuffle: bool = False) -> torch.Tensor:
    """3x3 SAME conv + bias (+ res) + LeakyReLU (+ pixel_shuffle(2)).

    x: (B, H, W, Cin) NHWC, f32 or bf16; w: (Cout, Cin, 3, 3) OIHW, cast to
    x's dtype; b: (Cout,), read in f32 (callers round it first where the
    reference does). res: optional (B // res_repeat, H, W, Cout) residual in
    x's dtype or f32, added before the activation and shared by each group
    of ``res_repeat`` consecutive batch items. slope=1.0 makes the
    activation the identity. Output dtype = x's dtype.
    """
    if x.device.type == "cpu":
        out = conv3x3_plain(x, w, b, slope, dilation, res, res_repeat)
    else:
        out = _conv3x3_cuda(x, w, b, slope, dilation, res, res_repeat)
    return pixel_shuffle(out, 2) if shuffle else out


fused_conv3x3.launches = 0

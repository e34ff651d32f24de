"""Shared building blocks of the port's model.

Activations are NHWC, as in the JAX package. Each conv module owns an OIHW
``weight`` and a ``bias`` kept in f32. Every stride-1 3x3 conv goes through
``ops.fused_conv3x3`` (the CUDA kernel on the card) with the weight in the
kernel's layout, prepared once per compute dtype and kept until the
parameters change (an optimizer's in-place step bumps their ``_version``),
with the parameters themselves beside it when gradients are wanted;
stride-2 convs and the tiny-output convs are plain PyTorch, as they were
plain XLA in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from video_super_resolution_tpu_torch.ops.fused_conv import (
    PreparedConv3x3,
    fused_conv3x3,
    prepare_conv3x3_weight,
)
from video_super_resolution_tpu_torch.ops.resize import edge_pad


def lrelu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


class _Conv3x3(nn.Module):
    """Owns an OIHW 3x3 ``weight`` and a ``bias``, both f32, and their
    kernel layout per compute dtype (``prepared``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        self._prepared: dict = {}

    def prepared(self, dtype: torch.dtype, cin: slice = slice(None),
                 with_bias: bool = True) -> PreparedConv3x3:
        """The weight's input channels ``cin`` and the bias rounded to
        ``dtype`` (zeros if not ``with_bias``) in the kernel's layout. Built
        on first use and rebuilt when a parameter is updated in place
        (``_version``) or replaced or moved (``data_ptr``)."""
        w, b = self.weight, self.bias
        key = (dtype, cin.start, cin.stop, with_bias)
        stamp = (w._version, w.data_ptr(), w.device, b._version, b.data_ptr())
        hit = self._prepared.get(key)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                bias = b.to(dtype) if with_bias else torch.zeros_like(b)
                hit = (stamp, prepare_conv3x3_weight(w[:, cin], bias, dtype))
            self._prepared[key] = hit
        return hit[1]

    def conv(self, x: torch.Tensor, dtype: torch.dtype, slope: float,
             dilation: int = 1, res: Optional[torch.Tensor] = None,
             res_repeat: int = 1, cin: slice = slice(None),
             with_bias: bool = True) -> torch.Tensor:
        """``fused_conv3x3`` of x (cast to ``dtype``) with the weight's input
        channels ``cin`` and, if ``with_bias``, the bias, in the kernel's
        layout; with grad enabled the parameters themselves ride along, so
        that their gradients reach ``weight`` and ``bias``."""
        params = None
        if torch.is_grad_enabled():
            params = (self.weight[:, cin], self.bias if with_bias else None)
        return fused_conv3x3(x.to(dtype).contiguous(),
                             self.prepared(dtype, cin, with_bias), None,
                             slope, dilation, res, res_repeat, params=params)


class ConvLReLU(_Conv3x3):
    """3x3 conv + bias + LeakyReLU. Stride 1 (any dilation) runs the fused
    kernel; stride 2 pads symmetrically by 1 (torch ``Conv2d(padding=1)``
    semantics), adds the f32 bias to the conv output, rounds to the compute
    dtype and activates."""

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dilation: int = 1, slope: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, features)
        self.strides = strides
        self.dilation = dilation
        self.slope = slope
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.strides == 1:
            return self.conv(x, dt, self.slope, self.dilation)
        out = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), None,
                       stride=self.strides, padding=self.dilation,
                       dilation=self.dilation).permute(0, 2, 3, 1)
        out = (out.to(torch.float32) + self.bias).to(dt)
        return lrelu(out, self.slope)


class RoutedConv(_Conv3x3):
    """3x3 SAME conv + bias with no activation (the kernel at slope 1.0).

    res: optional (B, H, W, features) residual added before the output cast
    (the ResBlock skip, the folded bilinear skip). out_dtype: dtype of the
    result (defaults to the compute dtype)."""

    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 out_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, features)
        self.dtype = dtype
        self.out_dtype = out_dtype or dtype

    def forward(self, x: torch.Tensor,
                res: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.conv(x, self.dtype, 1.0, res=res).to(self.out_dtype)


def tap_sum_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """3x3 SAME conv with few output channels as a channel contraction
    ((Cin, 9*Cout) matmul of the ``dtype`` values, f32 accumulation) plus 9
    shifted f32 adds, bias first. Returns f32 (B, H, W, Cout)."""
    b, h, w, f = x.shape
    co = weight.shape[0]
    k9 = weight.to(dtype).to(torch.float32).permute(1, 0, 2, 3).reshape(f, co * 9)
    u = (x.to(dtype).to(torch.float32).reshape(-1, f) @ k9).reshape(b, h, w, co, 9)
    up = F.pad(u, (0, 0, 0, 0, 1, 1, 1, 1))
    out = bias.to(torch.float32)
    for dy in range(3):
        for dx in range(3):
            out = out + up[:, dy:dy + h, dx:dx + w, :, dy * 3 + dx]
    return out


class SmallOutConv(_Conv3x3):
    """3x3 SAME conv with a tiny output-channel count (flow residuals,
    depth), f32 in and out, as ``tap_sum_conv``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tap_sum_conv(x, self.weight, self.bias, torch.float32)


class ResBlock(nn.Module):
    """conv-lrelu-conv + identity skip; wide=True is C -> 2C -> C. The skip
    is the second conv's ``res`` operand (added in the kernel's epilogue)."""

    def __init__(self, features: int, slope: float = 0.1,
                 dtype: torch.dtype = torch.float32, wide: bool = False):
        super().__init__()
        mid = 2 * features if wide else features
        self.ConvLReLU_0 = ConvLReLU(features, mid, slope=slope, dtype=dtype)
        self.Conv_0 = RoutedConv(mid, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ConvLReLU_0(x)
        return self.Conv_0(h, res=x.to(h.dtype))


def pad_to_multiple(x: torch.Tensor, mult: int
                    ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Replicate-pad H, W (axes -3, -2) at the end up to a multiple of mult."""
    h, w = x.shape[-3], x.shape[-2]
    ph = (-h) % mult
    pw = (-w) % mult
    if ph:
        x = edge_pad(x, x.ndim - 3, 0, ph)
    if pw:
        x = edge_pad(x, x.ndim - 2, 0, pw)
    return x, (h, w)


def crop_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return x[..., :h, :w, :]


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator,
                bias_std: float = 0.01) -> nn.Module:
    """Random weights from a seeded generator: LeCun-normal kernels
    (std 1/sqrt(fan_in)) and small normal biases."""
    for name, p in module.named_parameters():
        if p.ndim == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            p.copy_(torch.randn(p.shape, generator=generator)
                    / math.sqrt(fan_in))
        else:
            p.copy_(torch.randn(p.shape, generator=generator) * bias_std)
    return module

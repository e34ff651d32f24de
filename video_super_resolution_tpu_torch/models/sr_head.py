"""SR reconstruction head, ESPCN style: a residual conv trunk at LR, one
conv to 3 * scale^2 channels and one pixel_shuffle(scale), plus a bilinear
x``scale`` skip of the reference frame.

The skip is computed in pre-shuffle form (``upsample_bilinear_ps``) and
enters the subpixel conv as its ``res`` operand, which is exact because the
shuffle is a permutation. The subpixel conv runs in f32. The ``two_stage``
head style and ``sr_espcn_mid`` are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from video_super_resolution_tpu_torch.models.common import (
    ConvLReLU,
    ResBlock,
    RoutedConv,
)
from video_super_resolution_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from video_super_resolution_tpu_torch.ops.resize import upsample_bilinear_ps


class SRHead(nn.Module):
    def __init__(self, cin: int, features: int = 64, blocks: int = 5,
                 scale: int = 4, slope: float = 0.1, wide_blocks: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if scale not in (2, 4):
            raise ValueError("scale must be 2 or 4")
        self.scale = scale
        self.blocks = blocks
        self.dtype = dtype
        self.ConvLReLU_0 = ConvLReLU(cin, features, slope=slope, dtype=dtype)
        for i in range(blocks):
            self.add_module(f"ResBlock_{i}", ResBlock(
                features, slope=slope, dtype=dtype, wide=wide_blocks))
        self.Conv_0 = RoutedConv(features, features, dtype=dtype)
        self.subpixel_conv = RoutedConv(features, 3 * scale ** 2,
                                        dtype=torch.float32)

    def forward(self, fused: torch.Tensor, ref_frame: torch.Tensor) -> torch.Tensor:
        """fused (B, H, W, F), ref_frame (B, H, W, 3) -> (B, sH, sW, 3) f32."""
        h = self.ConvLReLU_0(fused.to(self.dtype))
        trunk_in = h
        for i in range(self.blocks):
            h = getattr(self, f"ResBlock_{i}")(h)
        h = self.Conv_0(h) + trunk_in                      # global trunk skip
        skip_ps = upsample_bilinear_ps(ref_frame.to(torch.float32), self.scale)
        out = self.subpixel_conv(h.to(torch.float32), res=skip_ps.contiguous())
        return pixel_shuffle(out, self.scale)

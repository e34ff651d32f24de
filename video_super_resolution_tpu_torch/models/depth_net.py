"""Monocular depth branch: hourglass encoder-decoder.

Stride-2 conv encoder, bilinear-upsample decoder with skip connections, a
1-channel inverse-depth output through softplus. W is replicate-padded to a
multiple of 4 * 2^levels and cropped after, as in the JAX package (a guard
against a TPU compiler fault there); the pad changes the numerics at the
right edge, so the port keeps it to match.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from video_super_resolution_tpu_torch.models.common import ConvLReLU, SmallOutConv
from video_super_resolution_tpu_torch.ops.resize import edge_pad, resize_bilinear


class DepthNet(nn.Module):
    def __init__(self, channels: int = 64, levels: int = 4, slope: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.levels = levels
        self.dtype = dtype
        c = channels
        convs = [ConvLReLU(3, c, slope=slope, dtype=dtype)]
        skips = []
        cin = c
        for l in range(levels):
            skips.append(cin)
            cl = min(c * 2 ** (l + 1), 4 * c)
            convs.append(ConvLReLU(cin, cl, strides=2, slope=slope, dtype=dtype))
            convs.append(ConvLReLU(cl, cl, slope=slope, dtype=dtype))
            cin = cl
        for l in reversed(range(levels)):
            convs.append(ConvLReLU(cin + skips[l], skips[l], slope=slope,
                                   dtype=dtype))
            cin = skips[l]
        for i, conv in enumerate(convs):
            self.add_module(f"ConvLReLU_{i}", conv)
        self.Conv_0 = SmallOutConv(cin, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H, W, 1) f32 inverse depth; H, W multiples of
        2^levels (the caller pads)."""
        w_in = x.shape[-2]
        w_mult = 4 * 2 ** self.levels
        if w_in % w_mult:
            x = edge_pad(x, x.ndim - 2, 0, (-w_in) % w_mult)
        h = self.ConvLReLU_0(x.to(self.dtype))
        skips = []
        i = 1
        for _ in range(self.levels):
            skips.append(h)
            h = getattr(self, f"ConvLReLU_{i}")(h)
            h = getattr(self, f"ConvLReLU_{i + 1}")(h)
            i += 2
        for l in reversed(range(self.levels)):
            skip = skips[l]
            h = resize_bilinear(h, skip.shape[1], skip.shape[2]).to(self.dtype)
            h = torch.cat([h, skip], dim=-1)
            h = getattr(self, f"ConvLReLU_{i}")(h)
            i += 1
        depth = self.Conv_0(h.to(torch.float32))
        return F.softplus(depth)[..., :, :w_in, :]

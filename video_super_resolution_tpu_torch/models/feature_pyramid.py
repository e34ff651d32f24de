"""Strided-conv feature pyramid (PWC-Net design).

Each level: a stride-2 conv then a stride-1 conv, both with LeakyReLU.
Level l has spatial size H/2^(l+1) and ``channels[l]`` features; the list
is returned finest first.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from video_super_resolution_tpu_torch.models.common import ConvLReLU


class FeaturePyramid(nn.Module):
    def __init__(self, channels: Tuple[int, ...] = (16, 32, 64, 96, 128),
                 slope: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = 3
        self.convs = []
        for i, c in enumerate(channels):
            for j, s in enumerate((2, 1)):
                name = f"ConvLReLU_{2 * i + j}"
                self.add_module(name, ConvLReLU(cin, c, strides=s,
                                                slope=slope, dtype=dtype))
                self.convs.append(name)
                cin = c

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        h = x
        for i, name in enumerate(self.convs):
            h = getattr(self, name)(h)
            if i % 2:
                feats.append(h)
        return feats

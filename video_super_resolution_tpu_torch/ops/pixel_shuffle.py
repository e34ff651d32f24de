"""Sub-pixel (pixel-shuffle) upsampling on NHWC tensors.

torch ``nn.PixelShuffle`` channel order: for C = c_out * r^2, channel
c_out * r^2 + ry * r + rx lands on output pixel offset (ry, rx).
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C*r^2) -> (B, H*r, W*r, C), torch channel order."""
    b, h, w, crr = x.shape
    if crr % (r * r) != 0:
        raise ValueError(f"channels {crr} not divisible by r^2={r * r}")
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H*r, W*r, C) -> (B, H, W, C*r^2), inverse of pixel_shuffle."""
    b, hr, wr, c = x.shape
    if hr % r or wr % r:
        raise ValueError(f"spatial dims ({hr},{wr}) not divisible by r={r}")
    h, w = hr // r, wr // r
    x = x.reshape(b, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h, w, c * r * r)

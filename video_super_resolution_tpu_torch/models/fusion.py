"""Depth-guided fusion of warped neighbor features.

Per neighbor, a conv head scores alignment quality from [ref_feat,
ref_depth, warped_feat, warped_depth, |depth difference|]; the scores are
soft-maxed across neighbors into per-pixel weights, and the weighted
neighbor aggregate is fused with the reference features and depth by two
convs. All neighbors are folded into the batch.
"""

from __future__ import annotations

import torch
from torch import nn

from video_super_resolution_tpu_torch.models.common import (
    ConvLReLU,
    _Conv3x3,
    tap_sum_conv,
)


class ScoreConv(_Conv3x3):
    """The 3x3 alignment-score conv over [ref_in, nbr_in], split by input
    linearity: the reference half runs once per batch item (no bias,
    identity activation, rounded to the compute dtype) and enters the
    neighbor conv as its ``res`` operand, shared by the N neighbors
    (res_repeat=N); the bias and the LeakyReLU run in that conv's epilogue.
    One (F, Cref + Cnbr, 3, 3) weight. Returns activated scores
    (B, N, H, W, F)."""

    def __init__(self, c_ref: int, c_nbr: int, features: int,
                 slope: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__(c_ref + c_nbr, features)
        self.c_ref = c_ref
        self.slope = slope
        self.dtype = dtype

    def forward(self, ref_in: torch.Tensor, nbr_in: torch.Tensor) -> torch.Tensor:
        b, n, h, w, cn = nbr_in.shape
        dt = self.dtype
        cr = self.c_ref
        s_ref = self.conv(ref_in, dt, 1.0, cin=slice(None, cr),
                          with_bias=False)
        s = self.conv(nbr_in.reshape(b * n, h, w, cn), dt, self.slope,
                      res=s_ref, res_repeat=n, cin=slice(cr, None))
        return s.reshape(b, n, h, w, -1)


class Score1(_Conv3x3):
    """3x3 conv F -> 1 as a channel contraction in the compute dtype with
    f32 accumulation plus 9 shifted f32 adds. Returns f32 (B, H, W, 1)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, 1)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tap_sum_conv(x, self.weight, self.bias, self.dtype)


class DepthGuidedFusion(nn.Module):
    def __init__(self, features: int = 64, slope: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = features
        self.dtype = dtype
        self.ScoreConv_0 = ScoreConv(f + 1, f + 2, f, slope, dtype)
        self.Score1_0 = Score1(f, dtype)
        self.ConvLReLU_0 = ConvLReLU(2 * f + 1, f, slope=slope, dtype=dtype)
        self.ConvLReLU_1 = ConvLReLU(f, f, slope=slope, dtype=dtype)

    def forward(self, ref_feat: torch.Tensor,       # (B, H, W, F)
                warped_feats: torch.Tensor,         # (B, N, H, W, F)
                ref_depth: torch.Tensor,            # (B, H, W, 1)
                warped_depths: torch.Tensor,        # (B, N, H, W, 1)
                ) -> torch.Tensor:
        b, n, h, w, f = warped_feats.shape
        dt = self.dtype
        ref_feat = ref_feat.to(dt)
        warped_feats = warped_feats.to(dt)
        ref_depth32 = ref_depth.to(torch.float32)
        warped_depths32 = warped_depths.to(torch.float32)

        ddiff = (warped_depths32 - ref_depth32[:, None]).abs()
        ref_in = torch.cat([ref_feat, ref_depth32.to(dt)], dim=-1)
        nbr_in = torch.cat([warped_feats, warped_depths32.to(dt),
                            ddiff.to(dt)], dim=-1)
        s = self.ScoreConv_0(ref_in, nbr_in)
        scores = self.Score1_0(s.reshape(b * n, h, w, -1)).reshape(b, n, h, w, 1)
        weights = torch.softmax(scores, dim=1)               # over neighbors
        agg = (weights * warped_feats.to(torch.float32)).sum(dim=1)
        fused_in = torch.cat([ref_feat, agg.to(dt), ref_depth32.to(dt)], dim=-1)
        return self.ConvLReLU_1(self.ConvLReLU_0(fused_in))

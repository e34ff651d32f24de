"""Coarse-to-fine optical flow with cost-volume correlation (PWC style).

Per estimated level, coarsest first:

    flow_up = 2 * bilinear_up(flow)                  # pixels at this level
    warped  = backward_warp(nbr_feat, flow_up)
    cv      = lrelu(correlation(ref_feat, warped))   # (2d+1)^2 channels,
                                                     # one fused call
    flow    = flow_up + estimator(cv, ref_feat, flow_up)

with a DenseNet-style estimator and a dilated-conv context network refining
the finest estimated level; the flow is then upsampled to full resolution.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from video_super_resolution_tpu_torch.models.common import (
    ConvLReLU,
    SmallOutConv,
)
from video_super_resolution_tpu_torch.models.feature_pyramid import FeaturePyramid
from video_super_resolution_tpu_torch.ops.correlation import correlation
from video_super_resolution_tpu_torch.ops.resize import resize_bilinear
from video_super_resolution_tpu_torch.ops.warp import backward_warp


class DenseFlowEstimator(nn.Module):
    """DenseNet-connected conv stack predicting an f32 2-channel residual."""

    def __init__(self, cin: int, channels: Tuple[int, ...] = (128, 128, 96, 64, 32),
                 slope: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"ConvLReLU_{i}",
                            ConvLReLU(cin, c, slope=slope, dtype=dtype))
            cin += c
        self.out_channels = cin
        self.Conv_0 = SmallOutConv(cin, 2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = x
        for i in range(self.n):
            out = getattr(self, f"ConvLReLU_{i}")(feats)
            feats = torch.cat([feats, out], dim=-1)
        return feats, self.Conv_0(feats.to(torch.float32))


class ContextNetwork(nn.Module):
    """Dilated-conv refinement of the finest flow (PWC context network)."""

    def __init__(self, cin: int,
                 channels: Tuple[int, ...] = (128, 128, 128, 96, 64, 32),
                 dilations: Tuple[int, ...] = (1, 2, 4, 8, 16, 1),
                 slope: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n = min(len(channels), len(dilations))
        for i, (c, d) in enumerate(zip(channels, dilations)):
            self.add_module(f"ConvLReLU_{i}", ConvLReLU(
                cin, c, dilation=d, slope=slope, dtype=dtype))
            cin = c
        self.Conv_0 = SmallOutConv(cin, 2)

    def forward(self, feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        h = torch.cat([feat.to(self.dtype), flow.to(self.dtype)], dim=-1)
        for i in range(self.n):
            h = getattr(self, f"ConvLReLU_{i}")(h)
        return self.Conv_0(h.to(torch.float32))


class FlowNet(nn.Module):
    """ref, nbr (B, H, W, 3) -> flow (B, H, W, 2) mapping ref pixels into
    nbr, in pixels at full resolution. H, W must be multiples of
    2^len(pyramid_channels) (the caller pads).

    Passing ref at its true batch B and the neighbors folded to B*N (the
    deduplicated form) runs one pyramid over [ref; nbrs] and shares the
    ref features across its N neighbors."""

    def __init__(self, pyramid_channels: Tuple[int, ...] = (16, 32, 64, 96, 128),
                 estimator_channels: Tuple[int, ...] = (128, 128, 96, 64, 32),
                 context_channels: Tuple[int, ...] = (128, 128, 128, 96, 64, 32),
                 max_displacement: int = 4, slope: float = 0.1,
                 dtype: torch.dtype = torch.float32, finest_level: int = 1):
        super().__init__()
        self.dtype = dtype
        self.slope = slope
        self.max_displacement = max_displacement
        self.levels = len(pyramid_channels)
        self.finest = min(finest_level, self.levels - 1)
        self.FeaturePyramid_0 = FeaturePyramid(pyramid_channels, slope, dtype)
        k = (2 * max_displacement + 1) ** 2
        est_out = None
        for l in range(self.finest, self.levels):
            est = DenseFlowEstimator(k + pyramid_channels[l] + 2,
                                     estimator_channels, slope, dtype)
            self.add_module(f"estimator_l{l}", est)
            if l == self.finest:
                est_out = est.out_channels
        self.ContextNetwork_0 = ContextNetwork(
            est_out + 2, context_channels, slope=slope, dtype=dtype)

    def forward(self, ref: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        ref = ref.to(dt)
        nbr = nbr.to(dt)
        pyramid = self.FeaturePyramid_0
        if ref.shape[0] != nbr.shape[0]:
            br, bn = ref.shape[0], nbr.shape[0]
            n = bn // br
            if br * n != bn:
                raise ValueError(f"nbr batch {bn} is not a multiple of ref "
                                 f"batch {br}")
            pyr_all = pyramid(torch.cat([ref, nbr], dim=0))
            pyr_r = [p[:br, None].expand(br, n, *p.shape[1:])
                     .reshape(bn, *p.shape[1:]) for p in pyr_all]
            pyr_n = [p[br:] for p in pyr_all]
        else:
            pyr_r = pyramid(ref)
            pyr_n = pyramid(nbr)

        flow = None
        feat = None
        for l in reversed(range(self.finest, self.levels)):
            fr, fn = pyr_r[l], pyr_n[l]
            b, h, w, _ = fr.shape
            if flow is None:
                flow_up = torch.zeros((b, h, w, 2), dtype=torch.float32,
                                      device=fr.device)
                warped = fn
            else:
                flow_up = 2.0 * resize_bilinear(flow, h, w)
                warped = backward_warp(fn.contiguous(), flow_up.contiguous())
            cv = correlation(fr.contiguous(), warped.contiguous(),
                             self.max_displacement, slope=self.slope,
                             out_dtype=dt)
            est_in = torch.cat([cv, fr, flow_up.to(dt)], dim=-1)
            feat, residual = getattr(self, f"estimator_l{l}")(est_in)
            flow = flow_up + residual

        flow = flow + self.ContextNetwork_0(feat, flow)
        full_h, full_w = ref.shape[1], ref.shape[2]
        scale = float(2 ** (self.finest + 1))
        return scale * resize_bilinear(flow, full_h, full_w)

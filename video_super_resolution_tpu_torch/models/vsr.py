"""Full VSR model: flow -> warp -> depth-guided fusion -> SR head.

A temporal window (B, T, H, W, 3) -> the x4 HR center frame
(B, 4H, 4W, 3). Per-neighbor work (flow, warp) folds the neighbor axis into
the batch; per-frame work (depth, encoder) folds T likewise. The input is
replicate-padded to a multiple of 2^max(pyramid, depth levels) at the top
and the output cropped back. Submodule names follow the JAX package's
param tree, so that weights carry across by path.

Two alignment layouts (``ModelConfig.warp_features``): warp each
neighbor's frame and depth (4 channels), then encode the aligned frames
(the default); or encode every frame, then warp each neighbor's features
and depth together (F + 1 channels, the reference-era layout). Each stage
runs inside a ``torch.profiler.record_function`` range named after the
JAX package's stages (``flow``, ``depth``, ``fd`` (the neighbours'
frame or feature + depth concat), ``warp``, ``encode``, ``fusion``,
``sr``, and inside ``sr`` the head's ``sr_trunk``, ``sr_skip`` and
``sr_conv``), so a profile groups its device time by stage
(``tools/profile_prefix.py``). The ranges are ``models/graphs.py``'s
``stage``: where ``api.eval_step`` captures the forward in CUDA graphs,
they are also where one graph ends and the next begins.

The forward is ``align`` (the stages up to the warp, on the whole frame)
then ``reconstruct`` (the stages after it), which can also run on an H
strip of rows: the spatial sharding of ``parallel/spatial.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from video_super_resolution_tpu_torch.config import ModelConfig
from video_super_resolution_tpu_torch.models.common import (
    ConvLReLU,
    crop_to,
    pad_to_multiple,
)
from video_super_resolution_tpu_torch.models.depth_net import DepthNet
from video_super_resolution_tpu_torch.models.flow_net import FlowNet
from video_super_resolution_tpu_torch.models.fusion import DepthGuidedFusion
from video_super_resolution_tpu_torch.models.graphs import stage
from video_super_resolution_tpu_torch.models.sr_head import SRHead
from video_super_resolution_tpu_torch.ops.resize import resize_bilinear
from video_super_resolution_tpu_torch.ops.warp import backward_warp


class VSRModel(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        slope = cfg.lrelu_slope
        f = cfg.fusion_channels
        self.flow_net = FlowNet(
            pyramid_channels=cfg.pyramid_channels,
            estimator_channels=cfg.flow_estimator_channels,
            context_channels=cfg.context_channels,
            max_displacement=cfg.max_displacement, slope=slope, dtype=dtype,
            finest_level=cfg.flow_finest_level)
        self.depth_net = DepthNet(channels=cfg.depth_channels,
                                  levels=cfg.depth_levels, slope=slope,
                                  dtype=dtype)
        self.frame_encoder_0 = ConvLReLU(3, f, slope=slope, dtype=dtype)
        self.frame_encoder_1 = ConvLReLU(f, f, slope=slope, dtype=dtype)
        self.fusion = DepthGuidedFusion(features=f, slope=slope, dtype=dtype)
        self.sr_head = SRHead(f, features=cfg.sr_channels,
                              blocks=cfg.sr_blocks, scale=cfg.scale,
                              slope=slope, wide_blocks=cfg.sr_wide_blocks,
                              style=cfg.sr_head_style,
                              espcn_mid=cfg.sr_espcn_mid, dtype=dtype)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        return self.frame_encoder_1(self.frame_encoder_0(frames))

    def forward(self, window: torch.Tensor, return_aux: bool = False
                ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        a = self.align(window)
        hr = self.reconstruct(a)
        if return_aux:
            b, n, h, w = a["warped_depths"].shape[:4]
            h0, w0 = a["hw"]
            return {
                "hr": hr,
                "flows": a["flows"].reshape(b, n, h, w, 2)[:, :, :h0, :w0],
                "depth": a["ref_depth"][:, :h0, :w0],
            }
        return hr

    def align(self, window: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The stages up to and including the warp, on the whole padded
        frame: flow, depth, the warp (and, with ``warp_features``, the
        encoder before it). Returns what ``reconstruct`` reads; "hw" is the
        frame's size before padding."""
        cfg = self.cfg
        b, t, h0, w0, _ = window.shape
        center = t // 2
        mult = 2 ** max(len(cfg.pyramid_channels), cfg.depth_levels)
        window, (h0, w0) = pad_to_multiple(window, mult)
        _, _, h, w, _ = window.shape
        n = t - 1

        ref = window[:, center]                                      # (B,H,W,3)
        nbr_idx = [i for i in range(t) if i != center]
        nbrs_flat = torch.stack([window[:, i] for i in nbr_idx], dim=1
                                ).reshape(b * n, h, w, 3)

        # flow of every neighbor, ref passed at its true batch (dedup form)
        with stage("flow"):
            flows = self.flow_net(ref, nbrs_flat)                    # (B*N,H,W,2)

        # depth of all T frames, at 1/ddiv resolution
        frames_flat = window.reshape(b * t, h, w, 3)
        ddiv = cfg.depth_res_divisor or (2 if cfg.depth_at_half_res else 1)
        with stage("depth"):
            if ddiv > 1:
                d_low = self.depth_net(
                    resize_bilinear(frames_flat, h // ddiv, w // ddiv))
                depths = resize_bilinear(d_low, h, w).reshape(b, t, h, w, 1)
            else:
                depths = self.depth_net(frames_flat).reshape(b, t, h, w, 1)
        ref_depth = depths[:, center]

        f = cfg.fusion_channels
        out = {"ref": ref, "ref_depth": ref_depth, "flows": flows,
               "hw": (h0, w0)}
        if cfg.warp_features:
            # encode every frame, then warp features + depth (F + 1 channels)
            with stage("encode"):
                feats = self.encode(frames_flat).reshape(b, t, h, w, f)
            ref_feat = feats[:, center]
            with stage("fd"):
                nbr_feats = torch.stack([feats[:, i] for i in nbr_idx], dim=1)
                nbr_depths = torch.stack([depths[:, i] for i in nbr_idx],
                                         dim=1)
                fd = torch.cat([nbr_feats, nbr_depths.to(nbr_feats.dtype)],
                               dim=-1).reshape(b * n, h, w, f + 1)
            with stage("warp"):
                warped = backward_warp(fd, flows.contiguous())
            warped = warped.reshape(b, n, h, w, f + 1)
            out.update(ref_feat=ref_feat, warped_feats=warped[..., :f],
                       warped_depths=warped[..., f:])
        else:
            # warp frame + depth (4 channels); the tail encodes the frames
            with stage("fd"):
                nbr_depths = torch.stack([depths[:, i] for i in nbr_idx],
                                         dim=1)
                fd = torch.cat([nbrs_flat,
                                nbr_depths.reshape(b * n, h, w, 1)
                                .to(nbrs_flat.dtype)], dim=-1)
            with stage("warp"):
                warped = backward_warp(fd, flows.contiguous())
            out.update(warped_frames=warped[..., :3],
                       warped_depths=warped[..., 3:].reshape(b, n, h, w, 1))
        return out

    def reconstruct(self, a: Dict[str, Any],
                    rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """The stages after the warp (encode unless ``warp_features``,
        fusion, SR head) on ``align``'s output: on the padded rows
        ``rows`` = (c, d) only when given (an H strip, ``parallel/spatial``),
        else on all of them. Each conv pads the strip's edges with zeros, as
        the whole frame's; the SR head sees rows c to min(d, h0) of the
        frame cropped to (h0, w0). Returns the HR rows scale * c to
        scale * min(d, h0)."""
        h0, w0 = a["hw"]
        c, d = rows if rows is not None else (0, a["ref"].shape[1])
        ref = a["ref"][:, c:d]
        ref_depth = a["ref_depth"][:, c:d]
        warped_depths = a["warped_depths"][:, :, c:d]
        if self.cfg.warp_features:
            ref_feat = a["ref_feat"][:, c:d]
            warped_feats = a["warped_feats"][:, :, c:d]
        else:
            b, n, h, w = warped_depths.shape[:4]
            warped_frames = a["warped_frames"][:, c:d]
            with stage("encode"):
                enc = self.encode(torch.cat([ref, warped_frames.to(ref.dtype)],
                                            dim=0))
            ref_feat = enc[:b]
            warped_feats = enc[b:].reshape(b, n, h, w, -1)

        with stage("fusion"):
            fused = self.fusion(ref_feat, warped_feats, ref_depth,
                                warped_depths)
        hs = min(d, h0) - c
        with stage("sr"):
            return self.sr_head(crop_to(fused, hs, w0), crop_to(ref, hs, w0))

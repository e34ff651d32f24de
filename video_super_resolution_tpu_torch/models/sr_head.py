"""SR reconstruction head: a residual conv trunk at LR, then one of two
upsampling styles (``ModelConfig.sr_head_style``), as the JAX package's
``models/sr_head.py``:

- "espcn": an optional ``ConvLReLU`` to ``espcn_mid`` channels
  (``sr_espcn_mid`` > 0), one conv to 3 * scale^2 channels and one
  pixel_shuffle(scale), plus a bilinear x``scale`` skip of the reference
  frame. The skip is computed in pre-shuffle form (``upsample_bilinear_ps``)
  and enters the subpixel conv as its ``res`` operand, which is exact
  because the shuffle is a permutation. The subpixel conv runs in f32.
- "two_stage" (the reference-era layout, kept for weight parity): scale / 2
  stages of conv -> pixel_shuffle(2) -> LReLU in the compute dtype (the
  fused conv kernel with ``shuffle=True``, its bias rounded to the compute
  dtype, as the JAX package's Pallas route), named ``upsample_{u}``; a final
  3-channel f32 conv ``Conv_1`` at full resolution (``SmallOutConv``: the
  JAX package leaves it to XLA as ``nn.Conv``); plus the bilinear skip.

The forward runs in three ``record_function`` ranges (``models/graphs.py``'s
``stage``), the JAX package's ``stop_stage`` names: ``sr_trunk`` (the trunk
through its global skip), ``sr_skip`` (the bilinear skip) and ``sr_conv``
(``espcn_mid`` and the subpixel conv and shuffle, or the upsample stages,
``Conv_1`` and the skip add). The skip enters the subpixel conv's
epilogue, so it is computed first: the port's order is ``sr_trunk,
sr_skip, sr_conv`` where the JAX package's is ``sr_trunk, sr_conv,
sr_skip``.
"""

from __future__ import annotations

import torch
from torch import nn

from video_super_resolution_tpu_torch.models.common import (
    ConvLReLU,
    ResBlock,
    RoutedConv,
    SmallOutConv,
)
from video_super_resolution_tpu_torch.models.graphs import stage
from video_super_resolution_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from video_super_resolution_tpu_torch.ops.resize import (
    resize_bilinear,
    upsample_bilinear_ps,
)

STYLES = ("espcn", "two_stage")


class SRHead(nn.Module):
    def __init__(self, cin: int, features: int = 64, blocks: int = 5,
                 scale: int = 4, slope: float = 0.1, wide_blocks: bool = True,
                 style: str = "espcn", espcn_mid: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if scale not in (2, 4):
            raise ValueError("scale must be 2 or 4")
        if style not in STYLES:
            raise ValueError(f"sr_head_style must be one of {STYLES}, got "
                             f"{style!r}")
        self.scale = scale
        self.blocks = blocks
        self.style = style
        self.dtype = dtype
        self.ConvLReLU_0 = ConvLReLU(cin, features, slope=slope, dtype=dtype)
        for i in range(blocks):
            self.add_module(f"ResBlock_{i}", ResBlock(
                features, slope=slope, dtype=dtype, wide=wide_blocks))
        self.Conv_0 = RoutedConv(features, features, dtype=dtype)
        if style == "two_stage":
            for u in range(scale // 2):
                self.add_module(f"upsample_{u}", ConvLReLU(
                    features, 4 * features, slope=slope, dtype=dtype,
                    shuffle=True))
            self.Conv_1 = SmallOutConv(features, 3)
            return
        if espcn_mid:
            self.espcn_mid = ConvLReLU(features, espcn_mid, slope=slope,
                                       dtype=dtype)
        self.subpixel_conv = RoutedConv(espcn_mid or features, 3 * scale ** 2,
                                        dtype=torch.float32)

    def forward(self, fused: torch.Tensor, ref_frame: torch.Tensor) -> torch.Tensor:
        """fused (B, H, W, F), ref_frame (B, H, W, 3) -> (B, sH, sW, 3) f32."""
        with stage("sr_trunk"):
            h = self.ConvLReLU_0(fused.to(self.dtype))
            trunk_in = h
            for i in range(self.blocks):
                h = getattr(self, f"ResBlock_{i}")(h)
            h = self.Conv_0(h) + trunk_in                  # global trunk skip
        if self.style == "two_stage":
            _, hh, ww, _ = ref_frame.shape
            with stage("sr_skip"):
                skip = resize_bilinear(ref_frame.to(torch.float32),
                                       hh * self.scale, ww * self.scale)
            with stage("sr_conv"):
                for u in range(self.scale // 2):
                    h = getattr(self, f"upsample_{u}")(h)
                return self.Conv_1(h.to(torch.float32)) + skip
        with stage("sr_skip"):
            skip_ps = upsample_bilinear_ps(ref_frame.to(torch.float32),
                                           self.scale).contiguous()
        with stage("sr_conv"):
            if hasattr(self, "espcn_mid"):
                h = self.espcn_mid(h)
            out = self.subpixel_conv(h.to(torch.float32), res=skip_ps)
            return pixel_shuffle(out, self.scale)

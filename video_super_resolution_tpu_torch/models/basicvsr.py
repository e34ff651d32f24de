"""BasicVSR (Chan, Wang, Yu, Dong, Loy, CVPR 2021, arXiv:2012.02181) on the
port, after BasicSR's ``basicvsr_arch.py`` and ``spynet_arch.py``.

A whole clip (T, H, W, 3) -> its x4 frames. SPyNet estimates the flow of
every neighbour pair in both directions, batched over the clip's T - 1
pairs. A backward pass runs from frame T - 1 down to 0: the hidden state
is warped onto frame i by the flow (K4, zeros padding), concatenated
behind the frame and fed to a trunk of a 3x3 conv with LeakyReLU and
``num_block`` residual blocks (K1, its ReLU and residual epilogues); all T
states are kept. A forward pass with its own trunk runs from frame 0 up,
and at each frame the upsampler fuses the kept backward state with the
forward one (1x1 conv, cuDNN), upsamples twice by a 64->256 conv and a
pixel shuffle (K1's shuffle epilogue), and adds a 3x3 conv at 4K (K1),
a 3-channel f32 conv (``SmallOutConv``) and the x4 bilinear upsample of
the LR frame. Frame c's output depends on every frame of the clip.

SPyNet's 7x7 convs run through cuDNN in the compute dtype, but for the
last of each level, whose output is the flow's residual: it and the flows,
the frames' normalisation and pyramid stay f32. Activations are NHWC as in
the rest of the port; SPyNet's library ops see NCHW views of NHWC memory
(``channels_last``). Parameter names follow BasicSR's module tree, so a
BasicSR state dict loads by name.

``frames`` yields the HR frames one at a time, in order, each produced at
its step of the forward pass, for ``api.upscale_clip`` to copy back while
the next is computed. Each stage runs in a ``models/graphs.py:stage``
range: ``spynet`` once a clip, ``propagate_backward`` and
``propagate_forward`` once a step (the warp and the trunk), ``upsample``
once a frame (fusion to the skip add).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from video_super_resolution_tpu_torch.config import BasicVSRConfig
from video_super_resolution_tpu_torch.models.common import (
    ConvLReLU,
    RoutedConv,
    SmallOutConv,
    lrelu,
)
from video_super_resolution_tpu_torch.models.graphs import stage
from video_super_resolution_tpu_torch.ops.resize import resize_bilinear
from video_super_resolution_tpu_torch.ops.warp import backward_warp

SCALE = 4
SLOPE = 0.1
SPYNET_LEVELS = 6
SPYNET_MULT = 2 ** (SPYNET_LEVELS - 1)      # SPyNet's input size multiple
# ImageNet's channel mean and std, SPyNet's input normalisation
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """An NCHW view of NHWC ``x`` (its memory is ``channels_last``)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC contiguous of NCHW ``x``; no copy where ``x`` is
    ``channels_last``."""
    return x.permute(0, 2, 3, 1).contiguous()


class LibraryConv(nn.Module):
    """k x k SAME conv + bias of NCHW tensors through the library (cuDNN on
    the card), in ``dtype``: SPyNet's 7x7 convs and the 1x1 fusion."""

    def __init__(self, cin: int, cout: int, k: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.weight.shape[-1] // 2)


class BasicModule(nn.Module):
    """One SPyNet level: five 7x7 convs, 8 -> 32 -> 64 -> 32 -> 16 -> 2, a
    ReLU between each; the last in f32 (the flow's residual)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        widths = (8, 32, 64, 32, 16, 2)
        layers = []
        for i in range(5):
            last = i == 4
            layers.append(LibraryConv(widths[i], widths[i + 1], 7,
                                      torch.float32 if last else dtype))
            if not last:
                layers.append(nn.ReLU())
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.basic_module(x)


class SpyNet(nn.Module):
    """SPyNet: ref, supp (N, H, W, 3) f32 in [0, 1], H and W above 32 ->
    flow (N, H, W, 2) f32 in pixels, such that supp sampled at x + flow(x)
    lands on ref."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.basic_module = nn.ModuleList(BasicModule(dtype)
                                          for _ in range(SPYNET_LEVELS))

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = ref.shape
        hf = -(-h // SPYNET_MULT) * SPYNET_MULT
        wf = -(-w // SPYNET_MULT) * SPYNET_MULT
        if min(hf, wf) < 2 * SPYNET_MULT:
            # the coarsest level would be one pixel, and BasicSR's starting
            # flow, half of it, none
            raise ValueError(f"SpyNet needs H and W above {SPYNET_MULT}, got "
                             f"{h}x{w}")
        x = nchw(torch.cat([ref, supp]).to(torch.float32))
        if (hf, wf) != (h, w):
            x = F.interpolate(x, size=(hf, wf), mode="bilinear",
                              align_corners=False)
        mean = x.new_tensor(MEAN).view(1, 3, 1, 1)
        std = x.new_tensor(STD).view(1, 3, 1, 1)
        pyramid = [(x - mean) / std]
        for _ in range(SPYNET_LEVELS - 1):
            pyramid.insert(0, F.avg_pool2d(pyramid[0], 2, 2,
                                           count_include_pad=False))
        flow = None
        for level, frames in enumerate(pyramid):
            frames = nhwc(frames)
            ref_l, supp_l = frames[:n], frames[n:]
            if flow is None:
                # BasicSR's starting flow is zero: its upsample is zero and
                # the warp by it is the identity
                up = ref_l.new_zeros((n, *ref_l.shape[1:3], 2))
                warped = supp_l
            else:
                up = self.upsample_flow(flow, ref_l.shape[1:3])
                warped = backward_warp(supp_l, up, "border")
            inp = torch.cat([ref_l, warped, up], dim=-1)
            flow = nhwc(self.basic_module[level](nchw(inp))) + up
        if (hf, wf) != (h, w):
            flow = nhwc(F.interpolate(nchw(flow), size=(h, w),
                                      mode="bilinear", align_corners=False))
            flow = flow * flow.new_tensor((w / wf, h / hf))
        return flow

    @staticmethod
    def upsample_flow(flow: torch.Tensor, size: Tuple[int, int]
                      ) -> torch.Tensor:
        """x2 bilinear (``align_corners=True``) of the coarser level's flow,
        doubled, its last row and column replicated up to ``size``."""
        up = F.interpolate(nchw(flow), scale_factor=2, mode="bilinear",
                           align_corners=True) * 2.0
        ph, pw = size[0] - up.shape[2], size[1] - up.shape[3]
        if ph or pw:
            up = F.pad(up, [0, pw, 0, ph], mode="replicate")
        return nhwc(up)


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))): the ReLU is conv1's epilogue (slope 0),
    the skip conv2's residual."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = ConvLReLU(features, features, slope=0.0, dtype=dtype)
        self.conv2 = RoutedConv(features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x), res=x)


class ConvResidualBlocks(nn.Module):
    """A 3x3 conv with LeakyReLU, then ``blocks`` residual blocks. The
    LeakyReLU is the conv's epilogue; ``main.1`` stands in its place, so
    the blocks keep BasicSR's names (``main.2.<i>``)."""

    def __init__(self, cin: int, features: int, blocks: int,
                 dtype: torch.dtype):
        super().__init__()
        self.main = nn.Sequential(
            ConvLReLU(cin, features, slope=SLOPE, dtype=dtype), nn.Identity(),
            nn.Sequential(*(ResidualBlockNoBN(features, dtype)
                            for _ in range(blocks))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


class BasicVSR(nn.Module):
    """BasicVSR of ``cfg``, computing in ``dtype`` with f32 parameters;
    ``api.upscale_clip`` serves a clip of it through ``frames``."""

    def __init__(self, cfg: BasicVSRConfig = BasicVSRConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg.num_feat
        self.spynet = SpyNet(dtype)
        blocks = cfg.num_block
        self.backward_trunk = ConvResidualBlocks(c + 3, c, blocks, dtype)
        self.forward_trunk = ConvResidualBlocks(c + 3, c, blocks, dtype)
        self.fusion = LibraryConv(2 * c, c, 1, dtype)
        self.upconv1 = ConvLReLU(c, 4 * c, slope=SLOPE, dtype=dtype,
                                 shuffle=True)
        self.upconv2 = ConvLReLU(c, 4 * c, slope=SLOPE, dtype=dtype,
                                 shuffle=True)
        self.conv_hr = ConvLReLU(c, c, slope=SLOPE, dtype=dtype)
        self.conv_last = SmallOutConv(c, 3)
        # bytes of backward state the last clip held at once, counted from
        # the storages of the kept states
        self.state_bytes = 0

    def flows(self, clip: torch.Tensor
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """(backward, forward) flows of clip (T, H, W, 3), each
        (T - 1, H, W, 2): backward[i] brings frame i + 1 onto frame i,
        forward[i] frame i onto frame i + 1; one SPyNet call for both."""
        t = clip.shape[0]
        if t < 2:
            return None, None
        flows = self.spynet(torch.cat([clip[:-1], clip[1:]]),
                            torch.cat([clip[1:], clip[:-1]]))
        return flows[:t - 1], flows[t - 1:]

    def step(self, trunk: ConvResidualBlocks, frame: torch.Tensor,
             state: torch.Tensor, flow: Optional[torch.Tensor]
             ) -> torch.Tensor:
        """One propagation step: the state warped by ``flow`` onto
        ``frame`` (none at the first step), the frame and state
        concatenated, then the trunk."""
        if flow is not None:
            state = backward_warp(state, flow, "zeros")
        return trunk(torch.cat([frame.to(self.dtype), state], dim=-1))

    def upsample(self, frame: torch.Tensor, back: torch.Tensor,
                 fwd: torch.Tensor) -> torch.Tensor:
        """HR frame (1, 4H, 4W, 3) f32 of LR ``frame`` and its two states."""
        _, h, w, _ = frame.shape
        fused = lrelu(nhwc(self.fusion(nchw(torch.cat([back, fwd], dim=-1)))),
                      SLOPE)
        x = self.conv_hr(self.upconv2(self.upconv1(fused)))
        skip = resize_bilinear(frame.to(torch.float32), SCALE * h, SCALE * w)
        return self.conv_last(x.to(torch.float32)) + skip

    def frames(self, clip: torch.Tensor) -> Iterator[torch.Tensor]:
        """clip (T, H, W, 3) f32 -> each HR frame (1, 4H, 4W, 3) f32,
        unclipped, in order. The backward states are made before the first
        is yielded, and each is dropped once its frame is out."""
        t, h, w, _ = clip.shape
        with stage("spynet"):
            back_flows, fwd_flows = self.flows(clip)
        zero = clip.new_zeros((1, h, w, self.cfg.num_feat), dtype=self.dtype)
        state, kept = zero, [None] * t
        for i in reversed(range(t)):
            with stage("propagate_backward"):
                state = self.step(self.backward_trunk, clip[i:i + 1], state,
                                  back_flows[i:i + 1] if i < t - 1 else None)
            kept[i] = state
        self.state_bytes = sum({s.untyped_storage().data_ptr():
                                s.untyped_storage().nbytes()
                                for s in kept}.values())
        state = zero
        for i in range(t):
            with stage("propagate_forward"):
                state = self.step(self.forward_trunk, clip[i:i + 1], state,
                                  fwd_flows[i - 1:i] if i else None)
            with stage("upsample"):
                hr = self.upsample(clip[i:i + 1], kept[i], state)
            kept[i] = None
            # nothing here holds the frame while the next one is computed
            yield hr
            del hr

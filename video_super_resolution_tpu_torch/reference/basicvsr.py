"""Plain PyTorch reference of BasicVSR, NCHW, f32 throughout: what the
tests hold ``models/basicvsr.py`` against.

Written from BasicSR's ``basicsr/archs/basicvsr_arch.py`` and
``basicsr/archs/spynet_arch.py`` (Chan, Wang, Yu, Dong, Loy, "BasicVSR: The
Search for Essential Components in Video Super-Resolution and Beyond",
CVPR 2021, arXiv:2012.02181), with no kernels and nothing imported from the
port. The parameters are a dict of OIHW weights and biases named as
BasicSR's module tree names them (``param_shapes``).

- SPyNet: the frames resized bilinearly (``align_corners=False``) to
  multiples of 32, normalised by ImageNet's mean and std, a 6-level
  ``avg_pool2d`` pyramid; at each level, from the coarsest, five 7x7 convs
  (8 -> 32 -> 64 -> 32 -> 16 -> 2, ReLU between) on the reference frame,
  the neighbour warped by the x2 upsampled flow (``align_corners=True``,
  doubled, replicate-padded to size; ``padding_mode='border'``) and that
  flow, added to it; the flow resized back and scaled by w / w_floor and
  h / h_floor.
- Propagation: backward from frame T - 1, then forward from frame 0, each
  step warping the hidden state by the step's flow (``padding_mode=
  'zeros'``), concatenating ``[x_i, h]`` and running a 3x3 conv 67 -> 64
  with LeakyReLU 0.1 and ``num_block`` residual blocks
  ``x + conv2(relu(conv1(x)))``.
- Upsampler at each frame of the forward pass: 1x1 fusion of the backward
  and forward states with LeakyReLU; two 64 -> 256 convs, each with a x2
  pixel shuffle and LeakyReLU; ``conv_hr`` with LeakyReLU; ``conv_last``
  to 3 channels; plus the x4 bilinear upsample of the LR frame.

Departures from BasicSR: the clip comes in as (T, H, W, 3) and its frames
go out as (T, 4H, 4W, 3) (BasicSR: (B, T, 3, H, W), here B = 1); a clip
of one frame runs no SPyNet (BasicSR calls it on an empty batch); the warp
builds its pixel grid on the input's device and in its dtype; the weights
are the benchmark's seeded draw, not the pretrained files (``init_scale``
gives the draw BasicSR's init). ``forward`` runs with TF32 off, for
matmuls and cuDNN, and restores both switches after.

``Ops(quant=...)`` rounds the inputs of every conv and warp, and every
conv weight, to a lower precision (per-tensor scaled for fp8): the control
of the correctness check. ``Ops(record=True)`` lists every conv's shape
and kernel size, for the conv floor.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # float8_e4m3fn's largest finite value
SLOPE = 0.1
SCALE = 4
SPYNET_LEVELS = 6
SPYNET_WIDTHS = (8, 32, 64, 32, 16, 2)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


class Ops:
    """The reference's primitive ops, with an optional rounding of their
    inputs (``quant``: None, torch.bfloat16 or torch.float8_e4m3fn) and an
    optional record of the convs: (batch, out h, out w, cin, cout, runs in
    f32 in the configured model, kernel size)."""

    def __init__(self, quant: Optional[torch.dtype] = None,
                 record: bool = False):
        self.quant = quant
        self.convs: Optional[List[tuple]] = [] if record else None

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return x
        with torch.no_grad():
            if self.quant == torch.float8_e4m3fn:
                scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
                r = (x / scale).to(self.quant).to(x.dtype) * scale
            else:
                r = x.to(self.quant).to(x.dtype)
        return x + (r - x).detach()          # straight-through gradient

    def conv(self, p: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
             f32: bool = False) -> torch.Tensor:
        """SAME conv with the weight's square kernel, + bias."""
        w = p[name + ".weight"]
        k = w.shape[-1]
        y = F.conv2d(self.q(x), self.q(w), p[name + ".bias"], padding=k // 2)
        if self.convs is not None:
            self.convs.append((y.shape[0], y.shape[2], y.shape[3],
                               w.shape[1], w.shape[0], f32, k))
        return y

    def warp(self, img: torch.Tensor, flow: torch.Tensor,
             padding_mode: str) -> torch.Tensor:
        """BasicSR's ``flow_warp``: img (B, C, H, W) sampled bilinearly at
        (x + flow_x, y + flow_y), flow (B, 2, H, W) in pixels, through
        ``grid_sample`` with ``align_corners=True``."""
        img = self.q(img)
        _, _, h, w = img.shape
        ys = torch.arange(h, device=img.device, dtype=img.dtype)
        xs = torch.arange(w, device=img.device, dtype=img.dtype)
        grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack((grid_x, grid_y), 2).float()
        vgrid = grid + flow.permute(0, 2, 3, 1)
        vgrid_x = 2.0 * vgrid[..., 0] / max(w - 1, 1) - 1.0
        vgrid_y = 2.0 * vgrid[..., 1] / max(h - 1, 1) - 1.0
        return F.grid_sample(img, torch.stack((vgrid_x, vgrid_y), dim=3),
                             mode="bilinear", padding_mode=padding_mode,
                             align_corners=True)


# --- parameter tree ---------------------------------------------------------

TRUNKS = ("backward_trunk", "forward_trunk")


def _spynet_conv(level: int, i: int) -> str:
    return f"spynet.basic_module.{level}.basic_module.{2 * i}"


def _block_conv(trunk: str, block: int, conv: int) -> str:
    return f"{trunk}.main.2.{block}.conv{conv}"


def param_shapes(m: dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter, BasicSR's names, in a fixed order:
    SPyNet's levels, the backward and forward trunks, the fusion and the
    upsampler."""
    c, blocks = m["num_feat"], m["num_block"]
    convs = []
    for level in range(SPYNET_LEVELS):
        for i in range(5):
            convs.append((_spynet_conv(level, i), SPYNET_WIDTHS[i],
                          SPYNET_WIDTHS[i + 1], 7))
    for trunk in TRUNKS:
        convs.append((f"{trunk}.main.0", c + 3, c, 3))
        for b in range(blocks):
            convs += [(_block_conv(trunk, b, 1), c, c, 3),
                      (_block_conv(trunk, b, 2), c, c, 3)]
    convs += [("fusion", 2 * c, c, 1), ("upconv1", c, 4 * c, 3),
              ("upconv2", c, 4 * c, 3), ("conv_hr", c, c, 3),
              ("conv_last", c, 3, 3)]
    shapes = {}
    for name, cin, cout, k in convs:
        shapes[name + ".weight"] = (cout, cin, k, k)
        shapes[name + ".bias"] = (cout,)
    return shapes


def init_scale(m: dict) -> Dict[str, float]:
    """Factors on the harness's LeCun-normal draw (std 1 / sqrt(fan_in))
    that give BasicSR's init: the residual blocks' ``conv1`` and ``conv2``
    weights get ``default_init_weights(..., 0.1)``, Kaiming-normal (std
    sqrt(2 / fan_in)) times 0.1, so 0.1 sqrt(2); every other weight keeps
    ``nn.Conv2d``'s own ``kaiming_uniform_(a=sqrt(5))``, std 1 / sqrt(3
    fan_in), so 1 / sqrt(3) (BasicSR sets no init for them, and SPyNet's
    comes from a pretrained file it loads). Biases keep the draw."""
    out = {}
    for name, shape in param_shapes(m).items():
        if len(shape) != 4:
            continue
        block = ".main.2." in name
        out[name] = 0.1 * math.sqrt(2.0) if block else 1.0 / math.sqrt(3.0)
    return out


# --- the forward ------------------------------------------------------------

def spynet(p: Dict[str, torch.Tensor], ops: Ops, ref: torch.Tensor,
           supp: torch.Tensor) -> torch.Tensor:
    """ref, supp (N, 3, H, W) in [0, 1] -> flow (N, 2, H, W) in pixels."""
    h, w = ref.shape[2], ref.shape[3]
    w_floor = math.floor(math.ceil(w / 32.0) * 32.0)
    h_floor = math.floor(math.ceil(h / 32.0) * 32.0)
    ref = F.interpolate(ref, size=(h_floor, w_floor), mode="bilinear",
                        align_corners=False)
    supp = F.interpolate(supp, size=(h_floor, w_floor), mode="bilinear",
                         align_corners=False)
    mean = ref.new_tensor(MEAN).view(1, 3, 1, 1)
    std = ref.new_tensor(STD).view(1, 3, 1, 1)
    refs, supps = [(ref - mean) / std], [(supp - mean) / std]
    for _ in range(SPYNET_LEVELS - 1):
        refs.insert(0, F.avg_pool2d(refs[0], kernel_size=2, stride=2,
                                    count_include_pad=False))
        supps.insert(0, F.avg_pool2d(supps[0], kernel_size=2, stride=2,
                                     count_include_pad=False))
    flow = refs[0].new_zeros([refs[0].size(0), 2,
                              int(math.floor(refs[0].size(2) / 2.0)),
                              int(math.floor(refs[0].size(3) / 2.0))])
    for level in range(len(refs)):
        up = F.interpolate(flow, scale_factor=2, mode="bilinear",
                           align_corners=True) * 2.0
        if up.size(2) != refs[level].size(2):
            up = F.pad(up, [0, 0, 0, 1], mode="replicate")
        if up.size(3) != refs[level].size(3):
            up = F.pad(up, [0, 1, 0, 0], mode="replicate")
        x = torch.cat([refs[level], ops.warp(supps[level], up, "border"), up],
                      1)
        for i in range(5):
            x = ops.conv(p, _spynet_conv(level, i), x, f32=i == 4)
            if i < 4:
                x = F.relu(x)
        flow = x + up
    flow = F.interpolate(flow, size=(h, w), mode="bilinear",
                         align_corners=False)
    scale = flow.new_tensor((float(w) / float(w_floor),
                             float(h) / float(h_floor))).view(1, 2, 1, 1)
    return flow * scale


def step(p: Dict[str, torch.Tensor], m: dict, ops: Ops, trunk: str,
         frame: torch.Tensor, state: torch.Tensor,
         flow: Optional[torch.Tensor]) -> torch.Tensor:
    """One propagation step of ``trunk``: the state (1, C, H, W) warped by
    flow (1, 2, H, W) onto frame (1, 3, H, W), where there is a flow; then
    ``ConvResidualBlocks`` of ``[frame, state]``."""
    if flow is not None:
        state = ops.warp(state, flow, "zeros")
    x = F.leaky_relu(ops.conv(p, f"{trunk}.main.0",
                              torch.cat([frame, state], 1)), SLOPE)
    for b in range(m["num_block"]):
        r = F.relu(ops.conv(p, _block_conv(trunk, b, 1), x))
        x = x + ops.conv(p, _block_conv(trunk, b, 2), r)
    return x


def upsample(p: Dict[str, torch.Tensor], ops: Ops, frame: torch.Tensor,
             back: torch.Tensor, fwd: torch.Tensor) -> torch.Tensor:
    """HR frame (1, 3, 4H, 4W) of frame (1, 3, H, W) and its backward and
    forward states."""
    out = F.leaky_relu(ops.conv(p, "fusion", torch.cat([back, fwd], 1)), SLOPE)
    out = F.leaky_relu(F.pixel_shuffle(ops.conv(p, "upconv1", out), 2), SLOPE)
    out = F.leaky_relu(F.pixel_shuffle(ops.conv(p, "upconv2", out), 2), SLOPE)
    out = F.leaky_relu(ops.conv(p, "conv_hr", out), SLOPE)
    out = ops.conv(p, "conv_last", out, f32=True)
    base = F.interpolate(frame, scale_factor=SCALE, mode="bilinear",
                         align_corners=False)
    return out + base


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and cuDNN inside, the switches restored
    after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def forward(p: Dict[str, torch.Tensor], m: dict, x: torch.Tensor,
            ops: Optional[Ops] = None) -> torch.Tensor:
    """A whole clip x (T, H, W, 3) -> (T, 4H, 4W, 3), unclipped."""
    ops = ops or Ops()
    with no_tf32():
        frames = x.permute(0, 3, 1, 2)
        t, _, h, w = frames.shape
        if t > 1:
            flows_backward = spynet(p, ops, frames[:-1], frames[1:])
            flows_forward = spynet(p, ops, frames[1:], frames[:-1])
        state = frames.new_zeros(1, m["num_feat"], h, w)
        back = [None] * t
        for i in range(t - 1, -1, -1):
            flow = flows_backward[i:i + 1] if i < t - 1 else None
            state = step(p, m, ops, "backward_trunk", frames[i:i + 1], state,
                         flow)
            back[i] = state
        state = torch.zeros_like(state)
        out = []
        for i in range(t):
            flow = flows_forward[i - 1:i] if i > 0 else None
            state = step(p, m, ops, "forward_trunk", frames[i:i + 1], state,
                         flow)
            out.append(upsample(p, ops, frames[i:i + 1], back[i], state))
            back[i] = None
        return torch.cat(out).permute(0, 2, 3, 1)

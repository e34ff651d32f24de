"""Plain PyTorch reference of the VSR forward, NCHW, f32 throughout.

Written from the model's description (flow by a PWC-style pyramid with a
cost volume, a depth hourglass, backward warping, depth-guided fusion of
the warped neighbours, a residual SR trunk and a x4 head), with no
kernels and nothing imported from the port. The parameters are a dict of
OIHW weights and biases named as the model's parameter tree names them
(``param_shapes``), so the benchmark can hand the port and the reference
the same weights by name.

- Frames are replicate-padded at the bottom and right to a multiple of
  2^max(pyramid levels, depth levels), the output cropped back.
- Every stride-1 3x3 conv pads by its dilation (SAME); stride-2 convs pad
  by 1. Bilinear resizes are half-pixel (``align_corners=False``) with
  replicated edges; the warp samples 4 pixel taps at x + flow, taps
  outside the frame read 0.
- ``Ops(quant=...)`` rounds the inputs of every conv, correlation and
  warp, and every conv weight, to a lower precision (per-tensor scaled
  for fp8): the control of the correctness check. ``Ops(record=True)``
  lists every 3x3 conv's shape, for the conv floor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # float8_e4m3fn's largest finite value


class Ops:
    """The reference's primitive ops, with an optional rounding of their
    inputs (``quant``: None, torch.bfloat16 or torch.float8_e4m3fn) and an
    optional record of the 3x3 convs: (batch, out h, out w, cin, cout,
    runs in f32 in the configured model)."""

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
             slope: Optional[float] = None, stride: int = 1,
             dilation: int = 1, f32: bool = False,
             bias: bool = True) -> torch.Tensor:
        w = p[name + ".weight"]
        y = F.conv2d(self.q(x), self.q(w), p[name + ".bias"] if bias else None,
                     stride=stride, padding=dilation, dilation=dilation)
        if self.convs is not None:
            self.convs.append((y.shape[0], y.shape[2], y.shape[3],
                               w.shape[1], w.shape[0], f32))
        return y if slope is None else F.leaky_relu(y, slope)

    def correlation(self, f1: torch.Tensor, f2: torch.Tensor, d: int
                    ) -> torch.Tensor:
        """(B, C, H, W) x2 -> (B, (2d+1)^2, H, W): the channel mean of f1
        times f2 shifted by (dy, dx), row-major over [-d, d]^2, f2 zero
        outside the frame."""
        f1, f2 = self.q(f1), self.q(f2)
        _, c, h, w = f1.shape
        f2p = F.pad(f2, (d, d, d, d))
        planes = [(f1 * f2p[:, :, d + dy:d + dy + h, d + dx:d + dx + w]
                   ).sum(dim=1) / c
                  for dy in range(-d, d + 1) for dx in range(-d, d + 1)]
        return torch.stack(planes, dim=1)

    def warp(self, img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """img (B, C, H, W) sampled at (x + flow_x, y + flow_y), flow
        (B, 2, H, W) in pixels; bilinear over the 4 pixel taps, a tap
        outside the frame reads 0."""
        img = self.q(img)
        b, c, h, w = img.shape
        ys = torch.arange(h, device=img.device, dtype=torch.float32)[:, None]
        xs = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
        sx = xs + flow[:, 0]
        sy = ys + flow[:, 1]
        x0, y0 = torch.floor(sx), torch.floor(sy)
        wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
        flat = img.reshape(b, c, h * w)

        def tap(yi, xi):
            inside = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            g = torch.gather(flat, 2, idx.reshape(b, 1, h * w)
                             .expand(b, c, h * w)).reshape(b, c, h, w)
            return g * inside[:, None].to(g.dtype)

        return ((1 - wy) * (1 - wx) * tap(y0, x0) + (1 - wy) * wx * tap(y0, x0 + 1)
                + wy * (1 - wx) * tap(y0 + 1, x0) + wy * wx * tap(y0 + 1, x0 + 1))


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)


def pad_end(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Replicate-pad the bottom by ph rows and the right by pw columns."""
    return F.pad(x, (0, pw, 0, ph), mode="replicate") if ph or pw else x


# --- parameter tree ---------------------------------------------------------

def _convs(m: dict) -> List[Tuple[str, int, int]]:
    """(name, cin, cout) of every conv of model config ``m``."""
    out = []
    cin = 3
    for i, c in enumerate(m["pyramid_channels"]):
        out += [(f"flow_net.FeaturePyramid_0.ConvLReLU_{2 * i}", cin, c),
                (f"flow_net.FeaturePyramid_0.ConvLReLU_{2 * i + 1}", c, c)]
        cin = c
    k = (2 * m["max_displacement"] + 1) ** 2
    levels = len(m["pyramid_channels"])
    finest = min(m["flow_finest_level"], levels - 1)
    est_out = None
    for l in range(finest, levels):
        c0 = k + m["pyramid_channels"][l] + 2
        for i, c in enumerate(m["flow_estimator_channels"]):
            out.append((f"flow_net.estimator_l{l}.ConvLReLU_{i}", c0, c))
            c0 += c
        out.append((f"flow_net.estimator_l{l}.Conv_0", c0, 2))
        if l == finest:
            est_out = c0
    cin = est_out + 2
    for i, c in enumerate(m["context_channels"][:6]):
        out.append((f"flow_net.ContextNetwork_0.ConvLReLU_{i}", cin, c))
        cin = c
    out.append(("flow_net.ContextNetwork_0.Conv_0", cin, 2))
    c = m["depth_channels"]
    dl = [("depth_net.ConvLReLU_0", 3, c)]
    skips, cin = [], c
    for l in range(m["depth_levels"]):
        skips.append(cin)
        cl = min(c * 2 ** (l + 1), 4 * c)
        dl += [(None, cin, cl), (None, cl, cl)]
        cin = cl
    for l in reversed(range(m["depth_levels"])):
        dl.append((None, cin + skips[l], skips[l]))
        cin = skips[l]
    out += [(n or f"depth_net.ConvLReLU_{i}", a, b)
            for i, (n, a, b) in enumerate(dl)]
    out.append(("depth_net.Conv_0", cin, 1))
    f = m["fusion_channels"]
    out += [("frame_encoder_0", 3, f), ("frame_encoder_1", f, f),
            ("fusion.ScoreConv_0", 2 * f + 3, f), ("fusion.Score1_0", f, 1),
            ("fusion.ConvLReLU_0", 2 * f + 1, f), ("fusion.ConvLReLU_1", f, f)]
    s = m["sr_channels"]
    mid = 2 * s if m["sr_wide_blocks"] else s
    out.append(("sr_head.ConvLReLU_0", f, s))
    for i in range(m["sr_blocks"]):
        out += [(f"sr_head.ResBlock_{i}.ConvLReLU_0", s, mid),
                (f"sr_head.ResBlock_{i}.Conv_0", mid, s)]
    out.append(("sr_head.Conv_0", s, s))
    if m["sr_head_style"] == "two_stage":
        out += [(f"sr_head.upsample_{u}", s, 4 * s)
                for u in range(m["scale"] // 2)]
        out.append(("sr_head.Conv_1", s, 3))
    else:
        if m["sr_espcn_mid"]:
            out.append(("sr_head.espcn_mid", s, m["sr_espcn_mid"]))
        out.append(("sr_head.subpixel_conv", m["sr_espcn_mid"] or s,
                    3 * m["scale"] ** 2))
    return out


def param_shapes(m: dict) -> Dict[str, tuple]:
    """Name -> shape of every parameter of model config ``m``: OIHW 3x3
    weights and their biases."""
    shapes = {}
    for name, cin, cout in _convs(m):
        shapes[name + ".weight"] = (cout, cin, 3, 3)
        shapes[name + ".bias"] = (cout,)
    return shapes


# --- forward ----------------------------------------------------------------

def _flow(p, m, ops: Ops, ref, nbrs, n):
    """ref (B, 3, H, W), nbrs (B*N, 3, H, W) -> flow (B*N, 2, H, W) in
    pixels mapping ref pixels into each neighbour."""
    slope = m["lrelu_slope"]
    levels = len(m["pyramid_channels"])
    finest = min(m["flow_finest_level"], levels - 1)
    h = torch.cat([ref, nbrs], dim=0)
    b = ref.shape[0]
    pyr = []
    for i in range(levels):
        h = ops.conv(p, f"flow_net.FeaturePyramid_0.ConvLReLU_{2 * i}", h,
                     slope, stride=2)
        h = ops.conv(p, f"flow_net.FeaturePyramid_0.ConvLReLU_{2 * i + 1}",
                     h, slope)
        pyr.append(h)
    flow = feat = None
    for l in reversed(range(finest, levels)):
        fr = pyr[l][:b].repeat_interleave(n, dim=0)
        fn = pyr[l][b:]
        hh, ww = fr.shape[2:]
        if flow is None:
            flow_up = torch.zeros(fr.shape[0], 2, hh, ww, device=fr.device)
            warped = fn
        else:
            flow_up = 2.0 * resize(flow, hh, ww)
            warped = ops.warp(fn, flow_up)
        cv = F.leaky_relu(ops.correlation(fr, warped, m["max_displacement"]),
                          slope)
        feat = torch.cat([cv, fr, flow_up], dim=1)
        for i in range(len(m["flow_estimator_channels"])):
            out = ops.conv(p, f"flow_net.estimator_l{l}.ConvLReLU_{i}", feat,
                           slope)
            feat = torch.cat([feat, out], dim=1)
        flow = flow_up + ops.conv(p, f"flow_net.estimator_l{l}.Conv_0", feat,
                                  f32=True)
    x = torch.cat([feat, flow], dim=1)
    for i, d in enumerate((1, 2, 4, 8, 16, 1)[:len(m["context_channels"])]):
        x = ops.conv(p, f"flow_net.ContextNetwork_0.ConvLReLU_{i}", x, slope,
                     dilation=d)
    flow = flow + ops.conv(p, "flow_net.ContextNetwork_0.Conv_0", x, f32=True)
    full_h, full_w = ref.shape[2:]
    return float(2 ** (finest + 1)) * resize(flow, full_h, full_w)


def _depth(p, m, ops: Ops, x):
    """(B, 3, H, W) -> (B, 1, H, W) inverse depth: the hourglass, its input
    right-padded (replicate) to a width multiple of 4 * 2^levels."""
    slope = m["lrelu_slope"]
    levels = m["depth_levels"]
    w_in = x.shape[3]
    x = pad_end(x, 0, (-w_in) % (4 * 2 ** levels))
    h = ops.conv(p, "depth_net.ConvLReLU_0", x, slope)
    skips, i = [], 1
    for _ in range(levels):
        skips.append(h)
        h = ops.conv(p, f"depth_net.ConvLReLU_{i}", h, slope, stride=2)
        h = ops.conv(p, f"depth_net.ConvLReLU_{i + 1}", h, slope)
        i += 2
    for l in reversed(range(levels)):
        skip = skips[l]
        h = torch.cat([resize(h, *skip.shape[2:]), skip], dim=1)
        h = ops.conv(p, f"depth_net.ConvLReLU_{i}", h, slope)
        i += 1
    d = F.softplus(ops.conv(p, "depth_net.Conv_0", h, f32=True))
    return d[..., :w_in]


def _encode(p, m, ops, x):
    slope = m["lrelu_slope"]
    return ops.conv(p, "frame_encoder_1",
                    ops.conv(p, "frame_encoder_0", x, slope), slope)


def _fusion(p, m, ops: Ops, ref_feat, warped_feats, ref_depth, warped_depths):
    """ref_feat (B, F, H, W), warped_feats (B, N, F, H, W), depths with one
    channel -> fused (B, F, H, W)."""
    slope = m["lrelu_slope"]
    b, n, f, h, w = warped_feats.shape
    ddiff = (warped_depths - ref_depth[:, None]).abs()
    ref_in = torch.cat([ref_feat, ref_depth], dim=1)
    nbr_in = torch.cat([warped_feats, warped_depths, ddiff], dim=2)
    x = torch.cat([ref_in.repeat_interleave(n, dim=0),
                   nbr_in.reshape(b * n, -1, h, w)], dim=1)
    s = ops.conv(p, "fusion.ScoreConv_0", x, slope)
    scores = ops.conv(p, "fusion.Score1_0", s).reshape(b, n, 1, h, w)
    weights = torch.softmax(scores, dim=1)
    agg = (weights * warped_feats).sum(dim=1)
    x = torch.cat([ref_feat, agg, ref_depth], dim=1)
    return ops.conv(p, "fusion.ConvLReLU_1",
                    ops.conv(p, "fusion.ConvLReLU_0", x, slope), slope)


def _sr_head(p, m, ops: Ops, fused, ref):
    """fused (B, F, h, w), ref (B, 3, h, w) -> (B, 3, s h, s w)."""
    slope = m["lrelu_slope"]
    r = m["scale"]
    x = ops.conv(p, "sr_head.ConvLReLU_0", fused, slope)
    trunk_in = x
    for i in range(m["sr_blocks"]):
        y = ops.conv(p, f"sr_head.ResBlock_{i}.ConvLReLU_0", x, slope)
        x = ops.conv(p, f"sr_head.ResBlock_{i}.Conv_0", y) + x
    x = ops.conv(p, "sr_head.Conv_0", x) + trunk_in
    h, w = ref.shape[2:]
    skip = resize(ref, r * h, r * w)
    if m["sr_head_style"] == "two_stage":
        for u in range(r // 2):
            x = F.pixel_shuffle(ops.conv(p, f"sr_head.upsample_{u}", x, slope),
                                2)
        return ops.conv(p, "sr_head.Conv_1", x, f32=True) + skip
    if m["sr_espcn_mid"]:
        x = ops.conv(p, "sr_head.espcn_mid", x, slope)
    return F.pixel_shuffle(ops.conv(p, "sr_head.subpixel_conv", x, f32=True),
                           r) + skip


def forward(p: Dict[str, torch.Tensor], m: dict, window: torch.Tensor,
            ops: Optional[Ops] = None) -> torch.Tensor:
    """window (B, T, H, W, 3) in [0, 1] -> the centre frame upscaled,
    (B, s H, s W, 3), unclipped."""
    ops = ops or Ops()
    b, t, h0, w0, _ = window.shape
    x = window.permute(0, 1, 4, 2, 3).reshape(b * t, 3, h0, w0)
    mult = 2 ** max(len(m["pyramid_channels"]), m["depth_levels"])
    x = pad_end(x, (-h0) % mult, (-w0) % mult)
    h, w = x.shape[2:]
    frames = x.reshape(b, t, 3, h, w)
    c = t // 2
    n = t - 1
    nbr_idx = [i for i in range(t) if i != c]
    ref = frames[:, c]
    nbrs = frames[:, nbr_idx].reshape(b * n, 3, h, w)
    flows = _flow(p, m, ops, ref, nbrs, n)

    ddiv = m["depth_res_divisor"] or (2 if m["depth_at_half_res"] else 1)
    if ddiv > 1:
        depths = resize(_depth(p, m, ops, resize(x, h // ddiv, w // ddiv)),
                        h, w)
    else:
        depths = _depth(p, m, ops, x)
    depths = depths.reshape(b, t, 1, h, w)
    ref_depth = depths[:, c]
    nbr_depths = depths[:, nbr_idx].reshape(b * n, 1, h, w)

    f = m["fusion_channels"]
    if m["warp_features"]:
        feats = _encode(p, m, ops, x).reshape(b, t, f, h, w)
        ref_feat = feats[:, c]
        fd = torch.cat([feats[:, nbr_idx].reshape(b * n, f, h, w),
                        nbr_depths], dim=1)
        warped = ops.warp(fd, flows).reshape(b, n, f + 1, h, w)
        warped_feats, warped_depths = warped[:, :, :f], warped[:, :, f:]
    else:
        warped = ops.warp(torch.cat([nbrs, nbr_depths], dim=1), flows)
        enc = _encode(p, m, ops, torch.cat([ref, warped[:, :3]], dim=0))
        ref_feat = enc[:b]
        warped_feats = enc[b:].reshape(b, n, f, h, w)
        warped_depths = warped[:, 3:].reshape(b, n, 1, h, w)
    fused = _fusion(p, m, ops, ref_feat, warped_feats, ref_depth,
                    warped_depths)
    out = _sr_head(p, m, ops, fused[..., :h0, :w0], ref[..., :h0, :w0])
    return out.permute(0, 2, 3, 1)


def window_indices(num_frames: int, center: int, window: int) -> List[int]:
    """The frames around ``center``, clamped to the clip (replicate)."""
    r = window // 2
    return [min(max(i, 0), num_frames - 1)
            for i in range(center - r, center + r + 1)]

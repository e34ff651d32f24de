"""Separable bilinear and bicubic resize with the JAX package's pinned
semantics.

``resize_bilinear`` is torch ``F.interpolate(mode="bilinear",
align_corners=False)`` with replicate edges, computed the way the JAX
package computes it so that the two agree to f32 rounding. Each branch is a
different numeric path and is kept as one:

- both axes upsampled by the same integer r: ``upsample_bilinear_ps``
  followed by one ``pixel_shuffle``;
- one axis upsampled by an integer: per-phase blends of unit shifts;
- one axis halved exactly: the mean of pixel pairs;
- anything else: fixed-width tap gathers with precomputed weights, summed
  tap by tap in f32.

``resize_bicubic`` is the JAX package's at the preset that
``data/degrade.py`` uses, MATLAB ``imresize``: cubic a=-0.5, antialias,
replicate edges; separable tap gathers along H then W with weights computed
once per shape. The JAX resizes' other presets (torch-style a=-0.75,
align_corners, excluded edges, antialiased bilinear) are not ported.

The tap gathers' index and weight tables are built once per (in size, out
size, kernel, device) and kept on that device (``_device_tables``), so a
resize copies nothing from the host after its first call at a shape.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from video_super_resolution_tpu_torch.ops.pixel_shuffle import pixel_shuffle


def edge_pad(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Replicate-pad ``x`` along ``axis`` by ``lo`` before and ``hi`` after."""
    n = x.shape[axis]
    idx = torch.arange(-lo, n + hi, device=x.device).clamp_(0, n - 1)
    return x.index_select(axis, idx)


def _cubic_kernel(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0))


def _resample_weights(in_size: int, out_size: int, cubic: bool = False):
    """Tap indices (out, K) int64 and weights (out, K) f32 of one axis's
    resample; out-of-range taps clamp to the border. Linear: plain
    half-pixel taps. Cubic: MATLAB ``imresize``, a=-0.5 with antialias,
    which widens the kernel by the downscale factor."""
    scale = in_size / out_size
    support = 2.0 if cubic else 1.0
    s = scale if (cubic and scale > 1.0) else 1.0
    k_width = int(math.ceil(support * s)) * 2 + 2
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    first = np.floor(centers - support * s) + 1
    taps = first[:, None] + np.arange(k_width)[None, :]
    dist = (centers[:, None] - taps) / s
    w = (_cubic_kernel(dist, -0.5) if cubic
         else np.maximum(1 - np.abs(dist), 0.0))
    wsum = w.sum(axis=1, keepdims=True)
    w = w / np.where(wsum == 0, 1.0, wsum)
    idx = np.clip(taps, 0, in_size - 1).astype(np.int64)
    return idx, w.astype(np.float32)


# (in_size, out_size, cubic, device) -> the tap tables on that device. Never
# evicted: a CUDA graph captured from a resize reads its tables' memory.
_TABLES: dict = {}


def _device_tables(in_size: int, out_size: int, cubic: bool,
                   device: torch.device):
    """``_resample_weights`` on ``device``, one (index (out,) int64, weight
    (out,) f32) pair a tap, each contiguous: built and copied there once,
    so that a resize issues no host-to-device copy (and can be captured in
    a CUDA graph)."""
    key = (in_size, out_size, cubic, device)
    hit = _TABLES.get(key)
    if hit is None:
        idx, w = _resample_weights(in_size, out_size, cubic)
        hit = tuple((torch.from_numpy(idx[:, k].copy()).to(device),
                     torch.from_numpy(w[:, k].copy()).to(device))
                    for k in range(idx.shape[1]))
        _TABLES[key] = hit
    return hit


def _gather_axis(x: torch.Tensor, axis: int, out_size: int,
                 cubic: bool = False) -> torch.Tensor:
    """sum_k w[:, k] * x.take(idx[:, k], axis), tap by tap in f32, with
    ``_resample_weights(x.shape[axis], out_size, cubic)``'s taps."""
    wshape = [1] * x.ndim
    wshape[axis] = out_size
    out = None
    for idx, w in _device_tables(x.shape[axis], out_size, cubic, x.device):
        g = x.index_select(axis, idx).to(torch.float32)
        term = g * w.reshape(wshape)
        out = term if out is None else out + term
    return out


def _phase_taps(p: int, r: int):
    center = (p + 0.5) / r - 0.5
    lo = math.floor(center)
    return lo, center - lo


def upsample_bilinear_ps(x: torch.Tensor, r: int) -> torch.Tensor:
    """Integer-factor bilinear x``r`` upsample of NHWC, pre-shuffle form.

    Returns (B, H, W, C*r^2) f32 in pixel-shuffle channel order
    (c*r^2 + py*r + px): ``pixel_shuffle(result, r)`` is
    ``resize_bilinear(x, H*r, W*r)``. All r^2 phase blends are computed at
    low resolution, H blend first, then W."""
    b, h, w, c = x.shape
    xp = edge_pad(edge_pad(x, 1, 1, 1), 2, 1, 1).to(torch.float32)
    phases = []
    for py in range(r):
        ly, fy = _phase_taps(py, r)
        top = xp[:, ly + 1:ly + 1 + h]
        bot = xp[:, ly + 2:ly + 2 + h]
        hrow = top * (1.0 - fy) + bot * fy if fy else top
        for px in range(r):
            lx, fx = _phase_taps(px, r)
            left = hrow[:, :, lx + 1:lx + 1 + w]
            right = hrow[:, :, lx + 2:lx + 2 + w]
            phases.append(left * (1.0 - fx) + right * fx if fx else left)
    st = torch.stack(phases, dim=-1)              # (B,H,W,C,r^2)
    return st.reshape(b, h, w, c * r * r)


def _upsample_axis_int(x: torch.Tensor, axis: int, r: int) -> torch.Tensor:
    """Integer-factor bilinear upsample along one axis: each output phase is
    a blend of x and its edge-replicated unit shift."""
    in_size = x.shape[axis]
    xp = edge_pad(x, axis, 1, 1)
    phases = []
    for p in range(r):
        lo, frac = _phase_taps(p, r)
        i0 = xp.narrow(axis, lo + 1, in_size).to(torch.float32)
        i1 = xp.narrow(axis, lo + 2, in_size).to(torch.float32)
        phases.append(i0 * (1.0 - frac) + i1 * frac)
    st = torch.stack(phases, dim=axis + 1)
    shape = list(x.shape)
    shape[axis] = in_size * r
    return st.reshape(shape)


def _resample_axis(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if out_size % in_size == 0:
        return _upsample_axis_int(x, axis, out_size // in_size)
    if in_size == 2 * out_size:
        # exact 1/2: tap centers fall midway between pixel pairs
        shape = list(x.shape)
        shape[axis] = out_size
        shape.insert(axis + 1, 2)
        return x.to(torch.float32).reshape(shape).mean(dim=axis + 1)
    return _gather_axis(x, axis, out_size)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., out_h, out_w, C); returns
    the input dtype."""
    dtype = x.dtype
    h_ax = x.ndim - 3
    h, w = x.shape[h_ax], x.shape[h_ax + 1]
    if (x.ndim == 4 and out_h % h == 0 and out_w % w == 0
            and out_h // h > 1 and out_h // h == out_w // w):
        r = out_h // h
        return pixel_shuffle(upsample_bilinear_ps(x, r), r).to(dtype)
    y = _resample_axis(x, h_ax, out_h)
    y = _resample_axis(y, h_ax + 1, out_w)
    return y.to(dtype)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """MATLAB-preset bicubic resize of (..., H, W, C) (or (H, W)) to
    out_h x out_w, H first; returns the input dtype."""
    dtype = x.dtype
    h_ax = x.ndim - 3 if x.ndim >= 3 else 0
    y = x
    for axis, size in ((h_ax, out_h), (h_ax + 1, out_w)):
        y = _gather_axis(y, axis, size, cubic=True)
    return y.to(dtype)

"""The traffic's content, made on the device from the seed.

Frozen torch copies of the port's numpy clip generators
(``video_super_resolution_tpu_torch/data/synthetic.py``: the band-limited
and full-spectrum textures, ``moving_gradient_clip``, ``zooming_clip``,
``layered_clip``) and of its LR degradation
(``data/degrade.py`` through ``ops/resize.py:resize_bicubic``: MATLAB
``imresize``, cubic a=-0.5 with antialias, replicated edges). The frames
carry real motion (translation, zoom, occluding layers), so the flow net
and the warp do real work. The same seed gives the same frames on the
same device; they are not the numpy generators' frames bit for bit.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def _sample(tex: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor
            ) -> torch.Tensor:
    """Bilinear sample of tex (H, W, 3) at float coordinates (h, w)."""
    hmax, wmax = tex.shape[0] - 2, tex.shape[1] - 2
    y0 = torch.floor(sy).clamp(0, hmax)
    x0 = torch.floor(sx).clamp(0, wmax)
    wy = (sy - y0).clamp(0, 1)[..., None]
    wx = (sx - x0).clamp(0, 1)[..., None]
    y0, x0 = y0.long(), x0.long()
    return (tex[y0, x0] * (1 - wy) * (1 - wx) + tex[y0, x0 + 1] * (1 - wy) * wx
            + tex[y0 + 1, x0] * wy * (1 - wx) + tex[y0 + 1, x0 + 1] * wy * wx)


def _grid(h: int, w: int, dev) -> tuple:
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
    return ys, xs


def _normalize(img: torch.Tensor) -> torch.Tensor:
    img = img - img.min()
    return img / img.max()


def smooth_texture(h: int, w: int, gen: torch.Generator, dev,
                   octaves: int = 4) -> torch.Tensor:
    """Band-limited RGB texture in [0, 1]: octaves of coarse noise
    upsampled through its grid's corners."""
    img = torch.zeros(h, w, 3, device=dev)
    ys, xs = _grid(h, w, dev)
    for o in range(octaves):
        sh, sw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        coarse = _pad_far_edges(torch.rand(sh, sw, 3, generator=gen, device=dev))
        img += _sample(coarse, ys * (sh - 1) / max(h - 1, 1),
                       xs * (sw - 1) / max(w - 1, 1)) / 2 ** o
    return _normalize(img)


def _pad_far_edges(x: torch.Tensor) -> torch.Tensor:
    """Replicate one row and one column at the far edges (the sampler reads
    the tap after the last)."""
    x = torch.cat([x, x[-1:]], dim=0)
    return torch.cat([x, x[:, -1:]], dim=1)


def detail_texture(h: int, w: int, gen: torch.Generator, dev,
                   rough: float = 0.85) -> torch.Tensor:
    """Full-spectrum RGB texture in [0, 1]: octaves down to pixel scale,
    each ``rough`` times the amplitude of the one above."""
    img = torch.zeros(h, w, 3, device=dev)
    ys, xs = _grid(h, w, dev)
    amp = 1.0
    scale = 1 << max(1, int(math.log2(max(2, min(h, w) // 2))))
    while scale >= 1:
        sh, sw = math.ceil(h / scale) + 1, math.ceil(w / scale) + 1
        coarse = torch.rand(sh + 1, sw + 1, 3, generator=gen, device=dev)
        img += amp * _sample(coarse, ys / scale, xs / scale)
        amp *= rough
        scale //= 2
    return _normalize(img)


def moving_clip(t: int, h: int, w: int, dx: float, dy: float,
                gen: torch.Generator, dev, detail: bool = False) -> torch.Tensor:
    """A texture translating by (dx, dy) px a frame: (T, H, W, 3)."""
    pad = int(math.ceil(t * max(abs(dx), abs(dy)))) + 4
    tex = (detail_texture if detail else smooth_texture)(
        h + 2 * pad, w + 2 * pad, gen, dev)
    ys, xs = _grid(h, w, dev)
    return torch.stack([_sample(tex, ys + pad + dy * i, xs + pad + dx * i)
                        for i in range(t)])


def zooming_clip(t: int, h: int, w: int, zoom: float, gen: torch.Generator,
                 dev, detail: bool = False) -> torch.Tensor:
    """A texture zooming about its centre by ``zoom`` a frame (a flow that
    varies across the frame): (T, H, W, 3)."""
    s_max = zoom ** (t - 1) if zoom >= 1 else 1.0
    pad = int(math.ceil(max(h, w) * (s_max - 1) / 2)) + 4
    tex = (detail_texture if detail else smooth_texture)(
        h + 2 * pad, w + 2 * pad, gen, dev)
    cy, cx = (h - 1) / 2 + pad, (w - 1) / 2 + pad
    ys, xs = _grid(h, w, dev)
    return torch.stack([_sample(tex, cy + (ys + pad - cy) * zoom ** i,
                                cx + (xs + pad - cx) * zoom ** i)
                        for i in range(t)])


def layered_clip(t: int, h: int, w: int, rng: np.random.Generator,
                 gen: torch.Generator, dev, n_layers: int = 3,
                 max_speed: float = 3.0) -> torch.Tensor:
    """A translating background under ``n_layers`` elliptical patches, each
    with its own texture and motion (occlusions, flow discontinuities):
    (T, H, W, 3)."""
    pad = int(math.ceil(t * max_speed)) + 4
    hp, wp = h + 2 * pad, w + 2 * pad
    ys, xs = _grid(h, w, dev)
    ys, xs = ys + pad, xs + pad
    bg_v = rng.uniform(-max_speed, max_speed, 2)
    bg = detail_texture(hp, wp, gen, dev)
    layers = []
    for _ in range(n_layers):
        tex = detail_texture(hp, wp, gen, dev)
        cy, cx = rng.uniform(0.2, 0.8) * h + pad, rng.uniform(0.2, 0.8) * w + pad
        ry, rx = rng.uniform(0.12, 0.3) * h, rng.uniform(0.12, 0.3) * w
        v = -bg_v + rng.uniform(-max_speed / 2, max_speed / 2, 2)
        layers.append((tex, cy, cx, ry, rx, v))
    frames = []
    for i in range(t):
        img = _sample(bg, ys + bg_v[0] * i, xs + bg_v[1] * i)
        for tex, cy, cx, ry, rx, v in layers:
            sy, sx = ys + v[0] * i, xs + v[1] * i
            r = torch.sqrt(((sy - cy) / ry) ** 2 + ((sx - cx) / rx) ** 2)
            alpha = ((1.0 - r) * min(ry, rx)).clamp(0.0, 1.0)[..., None]
            img = img * (1 - alpha) + _sample(tex, sy, sx) * alpha
        frames.append(img)
    return torch.stack(frames)


def clip_pool(n: int, t: int, h: int, w: int, seed: int, dev) -> List[torch.Tensor]:
    """``n`` clips of ``t`` frames (h, w), f32 in [0, 1] on ``dev``: moving,
    layered and zooming textures in turn, their speeds drawn from the
    seed."""
    rng = np.random.default_rng(seed % 2 ** 63)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed % 2 ** 63)
    clips = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            dx, dy = rng.uniform(-3, 3, 2)
            c = moving_clip(t, h, w, dx, dy, gen, dev, detail=bool(i % 2))
        elif kind == 1:
            c = layered_clip(t, h, w, rng, gen, dev)
        else:
            c = zooming_clip(t, h, w, float(rng.uniform(1.005, 1.02)), gen,
                             dev, detail=bool(i % 2))
        clips.append(c.clamp(0.0, 1.0).contiguous())
    return clips


# --- degradation --------------------------------------------------------------

def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
                    np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a,
                             0.0))


def _bicubic_taps(in_size: int, out_size: int):
    """Tap indices and weights (out, K) of MATLAB's antialiased bicubic."""
    scale = in_size / out_size
    s = max(scale, 1.0)
    k = int(math.ceil(2.0 * s)) * 2 + 2
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    first = np.floor(centers - 2.0 * s) + 1
    taps = first[:, None] + np.arange(k)[None, :]
    wgt = _cubic((centers[:, None] - taps) / s)
    wsum = wgt.sum(axis=1, keepdims=True)
    wgt = wgt / np.where(wsum == 0, 1.0, wsum)
    return (np.clip(taps, 0, in_size - 1).astype(np.int64),
            wgt.astype(np.float32))


def degrade(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """(..., H, W, 3) in [0, 1] -> (..., H/scale, W/scale, 3), MATLAB
    bicubic, H first, clipped to [0, 1]."""
    y = hr
    for axis in (hr.ndim - 3, hr.ndim - 2):
        idx, wgt = _bicubic_taps(y.shape[axis], y.shape[axis] // scale)
        idx_t = torch.from_numpy(idx).to(hr.device)
        w_t = torch.from_numpy(wgt).to(hr.device)
        shape = [1] * y.ndim
        shape[axis] = idx.shape[0]
        acc = None
        for j in range(idx.shape[1]):
            term = y.index_select(axis, idx_t[:, j]) * w_t[:, j].reshape(shape)
            acc = term if acc is None else acc + term
        y = acc
    return y.clamp(0.0, 1.0)

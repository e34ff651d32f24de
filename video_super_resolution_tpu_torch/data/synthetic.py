"""Golden synthetic clips with analytically known flow.

The port's own copy of the JAX package's ``data/synthetic.py`` (numpy only;
the same seed gives the same clips in both packages).

Flow/warp/E2E tests should not need real datasets: a smooth random texture
translated by a known (dx, dy) per frame gives a clip whose ground-truth
optical flow is exactly that translation (away from borders).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from video_super_resolution_tpu_torch.data.degrade import degrade_bicubic


def _smooth_texture(h: int, w: int, rng: np.random.Generator,
                    octaves: int = 4) -> np.ndarray:
    """Band-limited random RGB texture in [0,1] — smooth enough for bilinear
    resampling to be near-exact under subpixel shifts."""
    img = np.zeros((h, w, 3), np.float64)
    for o in range(octaves):
        sh, sw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        coarse = rng.random((sh, sw, 3))
        ys = np.linspace(0, sh - 1, h)
        xs = np.linspace(0, sw - 1, w)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, sh - 1)
        x1 = np.minimum(x0 + 1, sw - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        up = (
            coarse[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
            + coarse[np.ix_(y0, x1)] * (1 - wy) * wx
            + coarse[np.ix_(y1, x0)] * wy * (1 - wx)
            + coarse[np.ix_(y1, x1)] * wy * wx
        )
        img += up / (2**o)
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def moving_gradient_clip(
    num_frames: int = 5,
    h: int = 64,
    w: int = 64,
    dx: float = 1.5,
    dy: float = -0.75,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Clip of a texture translating by (dx, dy) px/frame.

    Returns (frames (T,H,W,3) in [0,1], flow (2,) = per-frame (dx, dy)).
    Frame t samples the texture at position + t*(dx, dy) (backward warp from
    frame t to t+1 therefore uses flow (+dx, +dy)).
    """
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(num_frames * max(abs(dx), abs(dy)))) + 4
    tex = _smooth_texture(h + 2 * pad, w + 2 * pad, rng)
    ys = np.arange(h) + pad
    xs = np.arange(w) + pad
    frames = []
    for t in range(num_frames):
        sy = ys + dy * t
        sx = xs + dx * t
        y0 = np.floor(sy).astype(int)
        x0 = np.floor(sx).astype(int)
        wy = (sy - y0)[:, None, None]
        wx = (sx - x0)[None, :, None]
        f = (
            tex[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
            + tex[np.ix_(y0, x0 + 1)] * (1 - wy) * wx
            + tex[np.ix_(y0 + 1, x0)] * wy * (1 - wx)
            + tex[np.ix_(y0 + 1, x0 + 1)] * wy * wx
        )
        frames.append(f.astype(np.float32))
    return np.stack(frames), np.array([dx, dy], np.float32)


def zooming_clip(
    num_frames: int = 5,
    h: int = 64,
    w: int = 64,
    zoom: float = 1.02,
    seed: int = 0,
    rough: float = 0.0,
) -> np.ndarray:
    """Clip of a texture zooming about its center by ``zoom`` per frame.

    Unlike pure translation, zoom gives a spatially VARYING flow
    (flow(x) = (zoom^t - 1) * (x - center)), i.e. a nonzero flow gradient
    of (zoom - 1) px/px per frame step — exercising the warp kernels'
    in-tile spread/tap budgets, which uniform translation never does.
    Returns frames (T, H, W, 3) in [0, 1].
    """
    rng = np.random.default_rng(seed)
    s_max = zoom ** (num_frames - 1) if zoom >= 1 else 1.0
    pad = int(np.ceil(max(h, w) * (s_max - 1) / 2)) + 4
    # rough > 0 switches to the full-spectrum hard-regime texture
    tex = (_detail_texture(h + 2 * pad, w + 2 * pad, rng, rough)
           if rough else _smooth_texture(h + 2 * pad, w + 2 * pad, rng))
    cy, cx = (h - 1) / 2 + pad, (w - 1) / 2 + pad
    ys = np.arange(h) + pad
    xs = np.arange(w) + pad
    frames = []
    for t in range(num_frames):
        s = zoom**t
        sy = cy + (ys - cy) * s
        sx = cx + (xs - cx) * s
        y0 = np.floor(sy).astype(int)
        x0 = np.floor(sx).astype(int)
        wy = (sy - y0)[:, None, None]
        wx = (sx - x0)[None, :, None]
        f = (
            tex[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
            + tex[np.ix_(y0, x0 + 1)] * (1 - wy) * wx
            + tex[np.ix_(y0 + 1, x0)] * wy * (1 - wx)
            + tex[np.ix_(y0 + 1, x0 + 1)] * wy * wx
        )
        frames.append(f.astype(np.float32))
    return np.stack(frames)


def _detail_texture(h: int, w: int, rng: np.random.Generator,
                    rough: float = 0.85) -> np.ndarray:
    """Full-spectrum random RGB texture in [0,1].

    Unlike :func:`_smooth_texture` (band-limited at half resolution — easy
    for x4 SR, eval clips converge to ~41.5 dB), octaves continue down to
    PIXEL scale with amplitude ``rough`` per octave: the finest octaves
    alias under the x4 bicubic degrade and are fundamentally unrecoverable,
    which is what pins converged eval PSNR to the 25-32 dB regime real
    Vid4/REDS content lives in. rough controls the
    spectral slope (higher = more fine-scale energy = lower PSNR)."""
    img = np.zeros((h, w, 3), np.float64)
    amp = 1.0
    scale = 1 << max(1, int(np.log2(max(2, min(h, w) // 2))))
    ys = np.arange(h, dtype=np.float64)
    xs = np.arange(w, dtype=np.float64)
    while scale >= 1:
        sh = int(np.ceil(h / scale)) + 1
        sw = int(np.ceil(w / scale)) + 1
        coarse = rng.random((sh + 1, sw + 1, 3))
        sy = ys / scale
        sx = xs / scale
        y0 = np.floor(sy).astype(int)
        x0 = np.floor(sx).astype(int)
        wy = (sy - y0)[:, None, None]
        wx = (sx - x0)[None, :, None]
        img += amp * (
            coarse[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
            + coarse[np.ix_(y0, x0 + 1)] * (1 - wy) * wx
            + coarse[np.ix_(y0 + 1, x0)] * wy * (1 - wx)
            + coarse[np.ix_(y0 + 1, x0 + 1)] * wy * wx
        )
        amp *= rough
        scale //= 2
    img -= img.min()
    img /= img.max()
    return img.astype(np.float32)


def _sample_bilinear(tex: np.ndarray, sy: np.ndarray, sx: np.ndarray) -> np.ndarray:
    """Sample texture at float coords (2D arrays) with bilinear weights."""
    y0 = np.floor(sy).astype(int)
    x0 = np.floor(sx).astype(int)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    return (
        tex[y0, x0] * (1 - wy) * (1 - wx)
        + tex[y0, x0 + 1] * (1 - wy) * wx
        + tex[y0 + 1, x0] * wy * (1 - wx)
        + tex[y0 + 1, x0 + 1] * wy * wx
    ).astype(np.float32)


def detail_clip(
    num_frames: int = 7, h: int = 128, w: int = 128,
    dx: float = 1.5, dy: float = -0.75, seed: int = 0,
    rough: float = 0.85,
) -> np.ndarray:
    """Translating full-spectrum texture (hard-regime analogue of
    :func:`moving_gradient_clip`). Returns frames (T, H, W, 3)."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(num_frames * max(abs(dx), abs(dy)))) + 4
    tex = _detail_texture(h + 2 * pad, w + 2 * pad, rng, rough)
    yy = np.arange(h, dtype=np.float64)[:, None] + pad
    xx = np.arange(w, dtype=np.float64)[None, :] + pad
    yy, xx = np.broadcast_arrays(yy, xx)
    return np.stack([
        _sample_bilinear(tex, yy + dy * t, xx + dx * t)
        for t in range(num_frames)
    ])


def layered_clip(
    num_frames: int = 7, h: int = 128, w: int = 128, seed: int = 0,
    n_layers: int = 3, max_speed: float = 3.0, rough: float = 0.85,
) -> np.ndarray:
    """Occlusion + motion-discontinuity clip: a translating full-spectrum
    background with ``n_layers`` elliptical foreground patches, each with
    its own texture and an (often opposing) motion. Layer boundaries give
    the flow field hard discontinuities and dis-/re-occluded pixels — the
    failure mode uniform translation can never exercise. Masks translate with their layer and are sampled bilinearly
    (subpixel soft edges ~1 px)."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(num_frames * max_speed)) + 4
    hp, wp = h + 2 * pad, w + 2 * pad
    yy = np.arange(h, dtype=np.float64)[:, None] + pad
    xx = np.arange(w, dtype=np.float64)[None, :] + pad
    yy, xx = np.broadcast_arrays(yy, xx)

    bg_v = rng.uniform(-max_speed, max_speed, 2)
    bg_tex = _detail_texture(hp, wp, rng, rough)
    layers = []
    for _ in range(n_layers):
        tex = _detail_texture(hp, wp, rng, rough)
        cy = rng.uniform(0.2, 0.8) * h + pad
        cx = rng.uniform(0.2, 0.8) * w + pad
        ry = rng.uniform(0.12, 0.3) * h
        rx = rng.uniform(0.12, 0.3) * w
        # bias opposite to the background for strong relative motion
        v = -bg_v + rng.uniform(-max_speed / 2, max_speed / 2, 2)
        layers.append((tex, cy, cx, ry, rx, v))

    frames = []
    for t in range(num_frames):
        img = _sample_bilinear(bg_tex, yy + bg_v[0] * t, xx + bg_v[1] * t)
        for tex, cy, cx, ry, rx, v in layers:
            sy = yy + v[0] * t
            sx = xx + v[1] * t
            r = np.sqrt(((sy - cy) / ry) ** 2 + ((sx - cx) / rx) ** 2)
            alpha = np.clip((1.0 - r) * min(ry, rx), 0.0, 1.0)[..., None]
            img = img * (1 - alpha) + _sample_bilinear(tex, sy, sx) * alpha
        frames.append(img.astype(np.float32))
    return np.stack(frames)


def shear_clip(
    num_frames: int = 7, h: int = 128, w: int = 128,
    amp: float = 2.5, wavelength: float = 48.0, seed: int = 0,
    rough: float = 0.85,
) -> np.ndarray:
    """Sinusoidal-shear clip: frame t samples the texture at
    ``x + amp*t*sin(2*pi*y/wavelength)`` — a horizontal flow whose vertical
    gradient is ``amp*2*pi/wavelength`` px/px per frame step while the
    displacement itself stays bounded by ``amp`` per step: a large flow
    spread within a tile without leaving the flow net's displacement
    range."""
    rng = np.random.default_rng(seed)
    pad = int(np.ceil(num_frames * amp)) + 4
    tex = _detail_texture(h + 2 * pad, w + 2 * pad, rng, rough)
    yy = np.arange(h, dtype=np.float64)[:, None] + pad
    xx = np.arange(w, dtype=np.float64)[None, :] + pad
    yy, xx = np.broadcast_arrays(yy, xx)
    phase = np.sin(2 * np.pi * (yy - pad) / wavelength)
    return np.stack([
        _sample_bilinear(tex, yy, xx + amp * t * phase)
        for t in range(num_frames)
    ])


def add_noise(frames: np.ndarray, sigma: float, seed: int = 0) -> np.ndarray:
    """Per-frame iid Gaussian noise (clipped to [0,1]): the target carries
    irreducible noise (PSNR cap ~20*log10(1/sigma)) and the LR degrade sees
    a noisy signal — the bf16/serving stack must not lose additional dB on
    content where per-pixel errors are already large."""
    rng = np.random.default_rng(seed)
    return np.clip(
        frames + rng.normal(0.0, sigma, frames.shape), 0.0, 1.0
    ).astype(np.float32)


def synthetic_clip_pair(
    num_frames: int = 5, hr_h: int = 128, hr_w: int = 128, scale: int = 4,
    dx: float = 2.0, dy: float = -1.0, seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(lr_frames (T,h,w,3), hr_frames (T,H,W,3)) with MATLAB-bicubic LR."""
    hr, _ = moving_gradient_clip(num_frames, hr_h, hr_w, dx, dy, seed)
    lr = degrade_bicubic(hr, scale)
    return lr, hr

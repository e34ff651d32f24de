"""PSNR / SSIM with the Vid4/REDS4 eval conventions pinned.

The port's own copy of the JAX package's ``evaluation/metrics.py``.

Conventions (the choices that move PSNR by more than 0.05 dB):

- Images are float in [0, 1], RGB, NHWC or HWC.
- ``border_crop`` pixels are cropped from each side before computing
  (classic VSR protocol crops ``scale`` pixels).
- ``y_channel=True`` converts to the luma channel of ITU-R BT.601 *video
  range* YCbCr (MATLAB ``rgb2ycbcr``): Y = (65.481 R + 128.553 G + 24.966 B
  + 16) / 255 — the Vid4 convention.
- SSIM follows Wang et al. 2004: 11x11 Gaussian window, sigma 1.5,
  K1=0.01, K2=0.03, L=1, mean over the valid (un-padded) window positions —
  matching MATLAB ``ssim``/EDVR evaluation.

Pure numpy: metrics run on the host on eval outputs.
"""

from __future__ import annotations

import numpy as np


def rgb_to_y(img: np.ndarray) -> np.ndarray:
    """[0,1] RGB (..., 3) -> [0,1]-scaled BT.601 video-range luma (..., 1)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = (65.481 * r + 128.553 * g + 24.966 * b + 16.0) / 255.0
    return y[..., None]


def _prep(img: np.ndarray, y_channel: bool, border_crop: int) -> np.ndarray:
    img = np.asarray(img, np.float64)
    if y_channel:
        img = rgb_to_y(img)
    if border_crop > 0:
        img = img[..., border_crop:-border_crop, border_crop:-border_crop, :]
    return img


def psnr(pred: np.ndarray, target: np.ndarray, y_channel: bool = True,
         border_crop: int = 4) -> float:
    p = _prep(pred, y_channel, border_crop)
    t = _prep(target, y_channel, border_crop)
    mse = float(np.mean((p - t) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(1.0 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2 * sigma**2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2_valid(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    """2-D 'valid' correlation of (H, W) with the window, via stride tricks."""
    k = win.shape[0]
    h, w = img.shape
    shape = (h - k + 1, w - k + 1, k, k)
    strides = img.strides * 2
    patches = np.lib.stride_tricks.as_strided(img, shape, strides)
    return np.einsum("ijkl,kl->ij", patches, win)


def _ssim_single(p: np.ndarray, t: np.ndarray) -> float:
    """SSIM of one 2-D channel in [0,1]."""
    c1 = (0.01) ** 2
    c2 = (0.03) ** 2
    win = _gaussian_window()
    mu_p = _filter2_valid(p, win)
    mu_t = _filter2_valid(t, win)
    mu_pp = mu_p * mu_p
    mu_tt = mu_t * mu_t
    mu_pt = mu_p * mu_t
    s_pp = _filter2_valid(p * p, win) - mu_pp
    s_tt = _filter2_valid(t * t, win) - mu_tt
    s_pt = _filter2_valid(p * t, win) - mu_pt
    ssim_map = ((2 * mu_pt + c1) * (2 * s_pt + c2)) / (
        (mu_pp + mu_tt + c1) * (s_pp + s_tt + c2)
    )
    return float(ssim_map.mean())


def ssim(pred: np.ndarray, target: np.ndarray, y_channel: bool = True,
         border_crop: int = 4) -> float:
    p = _prep(pred, y_channel, border_crop)
    t = _prep(target, y_channel, border_crop)
    if p.ndim == 4:  # batch: average
        return float(np.mean([ssim(pi, ti, False, 0) for pi, ti in zip(p, t)]))
    vals = [_ssim_single(p[..., c], t[..., c]) for c in range(p.shape[-1])]
    return float(np.mean(vals))

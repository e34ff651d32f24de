"""Sliding-temporal-window clip dataset.

The port's own copy of the JAX package's ``data/dataset.py``: the same
numpy RNG calls in the same order, so one seed gives the same crops, flips
and temporal reversals in both packages.

Walks a root of clip directories of PNG frames (REDS/Vid4 layout), yields
(LR window, HR center) pairs. Two layouts:

- paired: ``lr_root/<clip>/<frame>.png`` + ``hr_root/<clip>/<frame>.png``
- HR-only: LR generated on the fly with the MATLAB-bicubic degradation.

Window policy at clip edges: "replicate"
clamps neighbor indices to the clip range (the window always has T frames);
"reflect" mirrors. Augmentation: random crop, H/V flips, temporal reverse.

Pure numpy (+ PIL, imported only to read an image file); batches are
assembled on the host and copied to the device by the train loop
(training/loop.py).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from video_super_resolution_tpu_torch.data.degrade import degrade_bicubic

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".npy")


def sliding_window_indices(num_frames: int, center: int, window: int,
                           edge_mode: str = "replicate") -> List[int]:
    """Frame indices of the temporal window around ``center``."""
    r = window // 2
    idx = list(range(center - r, center + r + 1))
    if edge_mode == "replicate":
        return [min(max(i, 0), num_frames - 1) for i in idx]
    if edge_mode == "reflect":
        if num_frames == 1:         # nothing to mirror (the loop below would
            return [0] * window     # not end)
        out = []
        for i in idx:
            while i < 0 or i >= num_frames:
                i = -i if i < 0 else 2 * (num_frames - 1) - i
            out.append(i)
        return out
    raise ValueError(f"bad edge_mode {edge_mode}")


def load_frame(path: str) -> np.ndarray:
    """Load one frame as float32 RGB in [0,1], HWC."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        return np.ascontiguousarray(arr[..., :3], np.float32)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def list_clips(root: str) -> Dict[str, List[str]]:
    """clip name -> sorted frame paths."""
    clips = {}
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        frames = sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if f.lower().endswith(_IMG_EXTS)
        )
        if frames:
            clips[name] = frames
    return clips


class ClipDataset:
    """Sliding-window sampler over clip directories (or in-memory arrays)."""

    def __init__(
        self,
        hr_root: Optional[str] = None,
        lr_root: Optional[str] = None,
        clips_hr: Optional[Dict[str, np.ndarray]] = None,
        clips_lr: Optional[Dict[str, np.ndarray]] = None,
        window: int = 3,
        scale: int = 4,
        crop_size: int = 64,
        augment: bool = True,
        edge_mode: str = "replicate",
        seed: int = 0,
    ):
        self.window = window
        self.scale = scale
        self.crop_size = crop_size
        self.augment = augment
        self.edge_mode = edge_mode
        self.rng = np.random.default_rng(seed)

        if clips_hr is not None:
            self._mem_hr = clips_hr
            if clips_lr is None:
                # degrade once up front — per-sample degradation of in-memory
                # clips would redo the same bicubic every epoch
                clips_lr = {
                    k: degrade_bicubic(np.asarray(v), scale)
                    for k, v in clips_hr.items()
                }
            self._mem_lr = clips_lr
            self._paths_hr = self._paths_lr = None
            self.clip_names = sorted(clips_hr)
        else:
            assert hr_root, "need hr_root or clips_hr"
            self._mem_hr = self._mem_lr = None
            self._paths_hr = list_clips(hr_root)
            self._paths_lr = list_clips(lr_root) if lr_root else None
            self.clip_names = sorted(self._paths_hr)
        if not self.clip_names:
            raise ValueError("no clips found")

    # ---------- frame access ----------
    def num_frames(self, clip: str) -> int:
        if self._mem_hr is not None:
            return len(self._mem_hr[clip])
        return len(self._paths_hr[clip])

    def _hr_frame(self, clip: str, t: int) -> np.ndarray:
        if self._mem_hr is not None:
            return self._mem_hr[clip][t]
        return load_frame(self._paths_hr[clip][t])

    def _lr_frame(self, clip: str, t: int) -> np.ndarray:
        if self._mem_hr is not None:
            if self._mem_lr is not None:
                return self._mem_lr[clip][t]
            return degrade_bicubic(self._mem_hr[clip][t][None], self.scale)[0]
        if self._paths_lr is not None:
            return load_frame(self._paths_lr[clip][t])
        return degrade_bicubic(self._hr_frame(clip, t)[None], self.scale)[0]

    # ---------- training sampling ----------
    def sample(self) -> Dict[str, np.ndarray]:
        """One random (lr window (T,h,w,3), hr center (H,W,3)) pair."""
        clip = self.clip_names[self.rng.integers(len(self.clip_names))]
        nf = self.num_frames(clip)
        center = int(self.rng.integers(nf))
        idx = sliding_window_indices(nf, center, self.window, self.edge_mode)
        lr = np.stack([self._lr_frame(clip, t) for t in idx])
        hr = self._hr_frame(clip, center)

        c, s = self.crop_size, self.scale
        lh, lw = lr.shape[1:3]
        if lh < c or lw < c:
            raise ValueError(f"LR frames {lh}x{lw} smaller than crop {c}")
        y0 = int(self.rng.integers(lh - c + 1))
        x0 = int(self.rng.integers(lw - c + 1))
        lr = lr[:, y0 : y0 + c, x0 : x0 + c]
        hr = hr[y0 * s : (y0 + c) * s, x0 * s : (x0 + c) * s]

        if self.augment:
            if self.rng.random() < 0.5:  # horizontal flip
                lr = lr[:, :, ::-1]
                hr = hr[:, ::-1]
            if self.rng.random() < 0.5:  # vertical flip
                lr = lr[:, ::-1]
                hr = hr[::-1]
            if self.rng.random() < 0.5:  # temporal reverse
                lr = lr[::-1]
        return {"lr": np.ascontiguousarray(lr), "hr": np.ascontiguousarray(hr)}

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of stacked batches {lr: (B,T,h,w,3), hr: (B,H,W,3)}."""
        while True:
            samples = [self.sample() for _ in range(batch_size)]
            yield {
                "lr": np.stack([s["lr"] for s in samples]),
                "hr": np.stack([s["hr"] for s in samples]),
            }

    # ---------- eval iteration ----------
    def eval_windows(self, clip: str) -> Iterator[Dict[str, np.ndarray]]:
        """All sliding windows of a clip, in timeline order (batch 1)."""
        nf = self.num_frames(clip)
        for center in range(nf):
            idx = sliding_window_indices(nf, center, self.window, self.edge_mode)
            lr = np.stack([self._lr_frame(clip, t) for t in idx])
            hr = self._hr_frame(clip, center)
            yield {"lr": lr[None], "hr": hr[None], "center": center}

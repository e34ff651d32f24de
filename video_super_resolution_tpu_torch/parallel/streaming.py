"""Streaming inference over the time and space axes, as the JAX package's
``parallel/streaming.py``: each time rank holds a contiguous block of the
clip's frames, exchanges its boundary frames with its neighbours
(``parallel/temporal.py``), builds its windows and runs them through the
model, with the stages after the warp on this rank's H strip when the
space axis has more than one rank (``parallel/spatial.py``). ``stream_clip``
feeds a host clip through it and gathers the frames in timeline order.

One program for both meshes: at space 1 the strip is the whole frame.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.data.loader import timeline_shard_indices
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.parallel.spatial import spatial_forward
from video_super_resolution_tpu_torch.parallel.temporal import temporal_shard_forward
from video_super_resolution_tpu_torch.runtime.mesh import AXIS_TIME, Mesh, all_gather

Program = Callable[[VSRModel, torch.Tensor], torch.Tensor]


def make_streaming_program(cfg: VSRConfig, mesh: Mesh,
                           frame_hw: Tuple[int, int], frames_per_device: int,
                           window_batch: Optional[int] = None) -> Program:
    """fn(model, frames_local (F, h, w, 3)) -> (F, h*scale, w*scale, 3):
    this time rank's HR frames (the same on each of its space ranks), f32,
    as the model returns them. The F windows run as one batched forward,
    or ``window_batch`` at a time."""
    window = cfg.model.window
    f = frames_per_device
    wb = window_batch or f

    def program(model: VSRModel, frames_local: torch.Tensor) -> torch.Tensor:
        want = (f, *frame_hw, 3)
        if tuple(frames_local.shape) != want:
            raise ValueError(f"local frames {tuple(frames_local.shape)} != "
                             f"{want}")

        def forward_windows(windows: torch.Tensor) -> torch.Tensor:
            return torch.cat([spatial_forward(model, windows[i:i + wb], mesh)
                              for i in range(0, len(windows), wb)])

        with torch.no_grad():
            run = temporal_shard_forward(forward_windows, mesh, window)
            return run(frames_local.to(mesh.device))

    return program


def stream_clip(program: Program, model: VSRModel, frames, mesh: Mesh
                ) -> np.ndarray:
    """Feed a host clip (T, h, w, 3) through ``program``: each time rank
    runs its block of frames; the HR frames of every time rank, gathered in
    timeline order, come back on every rank as numpy."""
    frames = torch.as_tensor(np.asarray(frames))
    idx = timeline_shard_indices(frames.shape[0], mesh)
    out = program(model, frames[idx.start:idx.stop])
    return torch.cat(all_gather(out, mesh, AXIS_TIME)).cpu().numpy()

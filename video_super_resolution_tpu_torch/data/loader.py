"""Process-local feeding, as the JAX package's ``data/loader.py``: one
process per rank, and each rank reads only what it computes on.

- ``load_timeline_shard``: streaming inference; a rank reads from disk only
  the contiguous block of the clip's frames its time coordinate owns.
- ``shard_train_batch``: training; each data rank samples its own local
  batch (its own RNG stream), and the global batch is their concatenation
  over the data axis. The ranks that share a data coordinate (along time,
  space or model) must be given the same batch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from video_super_resolution_tpu_torch.data.dataset import load_frame
from video_super_resolution_tpu_torch.runtime.mesh import AXIS_DATA, AXIS_TIME, Mesh


def timeline_shard_indices(num_frames: int, mesh: Mesh) -> range:
    """The frame indices this rank's time coordinate owns."""
    n, i = mesh.size(AXIS_TIME), mesh.index(AXIS_TIME)
    if num_frames % n:
        raise ValueError(f"frames {num_frames} % time axis {n} != 0")
    per = num_frames // n
    return range(i * per, (i + 1) * per)


def load_timeline_shard(frame_paths: List[str], mesh: Mesh) -> torch.Tensor:
    """This rank's block of the clip, (T / time, h, w, 3) f32 on its
    device, read from ``frame_paths`` (the whole clip's, in order)."""
    idx = timeline_shard_indices(len(frame_paths), mesh)
    local = np.stack([load_frame(frame_paths[i]) for i in idx])
    return torch.from_numpy(local).to(mesh.device)


def shard_train_batch(batch: Dict[str, np.ndarray], mesh: Mesh,
                      global_batch: int) -> Dict[str, torch.Tensor]:
    """This rank's local batch (global_batch / data samples) on its
    device."""
    n = mesh.size(AXIS_DATA)
    out = {}
    for k, v in batch.items():
        if len(v) * n != global_batch:
            raise ValueError(f"{k}: local batch {len(v)} x data axis {n} != "
                             f"global batch {global_batch}")
        out[k] = torch.as_tensor(np.asarray(v)).to(mesh.device)
    return out

"""Temporal context parallelism: timeline shards and the frame halo
exchange, as the JAX package's ``parallel/temporal.py``.

Rank i on the "time" axis owns frames [i*F, (i+1)*F). Every owned frame
needs r = window // 2 neighbours on each side, so before the forward each
rank sends its last r frames to the right neighbour and its first r to the
left one (``runtime.mesh.exchange_neighbors``). The timeline is not a ring:
the edge ranks fill the missing side by replicating their own edge frame,
which is the "replicate" clip-edge policy of ``data/dataset.py``, so the
sharded output equals the unsharded one.
"""

from __future__ import annotations

from typing import Callable

import torch

from video_super_resolution_tpu_torch.runtime.mesh import (
    AXIS_TIME,
    Mesh,
    exchange_neighbors,
)


def halo_exchange_frames(local: torch.Tensor, r: int, mesh: Mesh,
                         axis: str = AXIS_TIME) -> torch.Tensor:
    """(F, ...) local frames -> (F + 2r, ...): the r frames before them
    from the left neighbour and the r after from the right one; an edge
    rank replicates its edge frame (at one rank: the replicate pad)."""
    if r == 0:
        return local
    if local.shape[0] < r:
        raise ValueError(f"{local.shape[0]} frames a rank < halo {r}")
    from_left, from_right = exchange_neighbors(local[:r], local[-r:], mesh,
                                               axis)
    if from_left is None:
        from_left = local[:1].expand(r, *local.shape[1:])
    if from_right is None:
        from_right = local[-1:].expand(r, *local.shape[1:])
    return torch.cat([from_left, local, from_right], dim=0)


def _windows_from_extended(ext: torch.Tensor, num_centers: int,
                           window: int) -> torch.Tensor:
    """(F + 2r, ...) -> (F, window, ...) sliding windows."""
    return torch.stack([ext[i:i + window] for i in range(num_centers)])


def temporal_shard_forward(
    forward_windows: Callable[[torch.Tensor], torch.Tensor],
    mesh: Mesh,
    window: int,
    axis: str = AXIS_TIME,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(frames_local (F, h, w, 3)) -> (F, H, W, 3): the halo exchange,
    the rank's F windows, then ``forward_windows`` ((B, window, h, w, 3)
    -> (B, H, W, 3)) on them. Each rank runs its own frames only; the one
    communication is the 2r-frame exchange."""
    r = window // 2

    def shard_fn(frames_local: torch.Tensor) -> torch.Tensor:
        ext = halo_exchange_frames(frames_local, r, mesh, axis)
        return forward_windows(
            _windows_from_extended(ext, frames_local.shape[0], window))

    return shard_fn

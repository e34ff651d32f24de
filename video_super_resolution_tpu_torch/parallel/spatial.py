"""Spatial (H) sharding over the "space" axis: the counterpart of the JAX
package's ``parallel/spatial.py`` and of the time x space branch of its
``parallel/streaming.py``.

JAX lets GSPMD partition every op from sharding constraints and writes no
halo code. Here the design is explicit:

- flow, depth and the warp (the encoder too, with ``warp_features``) run
  on the whole frame on every space rank (``VSRModel.align``): they run at
  LR, and their receptive field covers the whole pyramid (x32, dilation 16);
- the stages after the warp (``VSRModel.reconstruct``: encode, fusion, SR
  head) run on an H strip: the rank's own LR rows and a halo of rows on
  each side as wide as those stages' receptive field (``halo_rows``),
  computed redundantly and cropped away;
- the strips are gathered in order (``runtime.mesh.all_gather``).

Two edges come out as unsharded: the encoder and fusion see the rows the
model padded to a multiple of 32 (``pad_to_multiple``), and the SR head
sees the frame cropped back to h0, so its zero padding starts at row h0
(``reconstruct`` crops each strip there).

``strip_rows`` and ``strip_forward`` are the counterparts of
``spatial_sharding`` and ``with_spatial_sharding``: the strip plan, and one
strip's forward.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from video_super_resolution_tpu_torch.models.common import _Conv3x3
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.runtime.mesh import (
    AXIS_SPACE,
    Mesh,
    all_gather,
)


def _rows(conv: torch.nn.Module) -> int:
    """Rows a stride-1 3x3 conv reaches on each side."""
    return getattr(conv, "dilation", 1)


def halo_rows(model: VSRModel) -> int:
    """LR rows on each side that a strip's own rows depend on through the
    stages after the warp, counted from the modules:

    - one row per 3x3 conv (times its dilation) of the encoder (unless
      ``warp_features``, which encodes before the warp) and of the fusion
      (score conv, score-to-1 conv, two fusion convs), in series;
    - the SR head: its LR convs in series (first conv, two a ResBlock,
      trunk conv, ``espcn_mid``, subpixel conv); for ``two_stage`` instead
      of the last two the upsample convs, each at twice the resolution of
      the one before, and the final conv at full resolution, in LR rows
      rounded up; beside them the bilinear skip's one-row tap, which
      enters only the output (the head needs the larger of the two).

    The espcn serving layout: encode 2 + fusion 4 + head 13 = 19."""
    cfg = model.cfg
    tail = [] if cfg.warp_features else [model.frame_encoder_0,
                                         model.frame_encoder_1]
    tail += [m for m in model.fusion.modules() if isinstance(m, _Conv3x3)]
    head = model.sr_head
    chain = _rows(head.ConvLReLU_0) + _rows(head.Conv_0)
    for i in range(head.blocks):
        block = getattr(head, f"ResBlock_{i}")
        chain += _rows(block.ConvLReLU_0) + _rows(block.Conv_0)
    if head.style == "two_stage":
        e = _rows(head.Conv_1)                 # at full resolution
        for u in reversed(range(head.scale // 2)):
            # shuffle to 2x halves the reach (rounded up), then the conv
            e = -(-e // 2) + _rows(getattr(head, f"upsample_{u}"))
        chain += e
    else:
        if hasattr(head, "espcn_mid"):
            chain += _rows(head.espcn_mid)
        chain += _rows(head.subpixel_conv)
    skip = 1
    return sum(_rows(m) for m in tail) + max(chain, skip)


@dataclasses.dataclass(frozen=True)
class Strip:
    """A strip's own LR rows [r0, r1) of the h0 output rows and the padded
    rows [lo, hi) it computes: its own rows and the halo, clipped to the
    frame."""

    r0: int
    r1: int
    lo: int
    hi: int


def strip_rows(h: int, n: int, halo: int,
               h_pad: Optional[int] = None) -> List[Strip]:
    """The plan of ``n`` strips over ``h`` LR rows: own rows as even as
    can be (the first h % n strips one row more), each computed with
    ``halo`` rows on each side, clipped to [0, h_pad) (the padded height,
    default h)."""
    if not 1 <= n <= h:
        raise ValueError(f"cannot cut {h} rows into {n} strips")
    h_pad = h if h_pad is None else h_pad
    base, extra = divmod(h, n)
    out, r0 = [], 0
    for k in range(n):
        r1 = r0 + base + (k < extra)
        out.append(Strip(r0, r1, max(0, r0 - halo), min(h_pad, r1 + halo)))
        r0 = r1
    return out


def strip_forward(model: VSRModel, window: torch.Tensor, index: int, n: int,
                  halo: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Strip]:
    """Strip ``index`` of ``n`` of the forward of ``window`` (B, T, h, w,
    3): (HR rows scale * r0 to scale * r1 (B, s(r1 - r0), sW, 3), the
    strip). ``halo`` defaults to ``halo_rows(model)``."""
    a = model.align(window)
    h0 = a["hw"][0]
    s = strip_rows(h0, n, halo_rows(model) if halo is None else halo,
                   a["ref"].shape[1])[index]
    hr = model.reconstruct(a, (s.lo, s.hi))
    k = model.cfg.scale
    return hr[:, k * (s.r0 - s.lo):k * (s.r1 - s.lo)], s


def spatial_forward(model: VSRModel, window: torch.Tensor, mesh: Mesh,
                    axis: str = AXIS_SPACE,
                    halo: Optional[int] = None) -> torch.Tensor:
    """The forward of ``window`` with the tail on this rank's H strip and
    the strips of every rank along ``axis`` gathered in order: (B, sH, sW,
    3) on every rank. Strips differ by at most one LR row: each is padded
    to the largest for the all-gather and cropped after."""
    n = mesh.size(axis)
    strip, _ = strip_forward(model, window, mesh.index(axis), n, halo)
    k = model.cfg.scale
    sizes = [k * (s.r1 - s.r0) for s in strip_rows(window.shape[2], n, 0)]
    padded = torch.nn.functional.pad(
        strip, (0, 0, 0, 0, 0, max(sizes) - strip.shape[1]))
    parts = all_gather(padded, mesh, axis)
    return torch.cat([p[:, :r] for p, r in zip(parts, sizes)], dim=1)

"""The backward warp against the library route of the same function at the
model's warp shapes: the port's counterpart of the JAX repo's
``tools/bench_warp.py``.

    python -m video_super_resolution_tpu_torch.tools.bench_warp \\
        [--impls kernel,library] [--shapes 'b,h,w,c;...'] [--n 32] \\
        [--flow-scale 6.0] [--check] [--device cpu]

The impls (JAX's ``pallas`` and the XLA gather; its ``tiled`` is a TPU
formulation that the port does not have):

- ``kernel``: ``ops.warp.backward_warp``, zeros padding (the CUDA kernel
  on the card);
- ``library``: ``warp_library``, ``F.grid_sample`` on an f32 image and
  an f32 normalised grid.

``--check`` adds each impl's ``max_abs_diff_vs_plain`` against
``ops.warp.warp_plain``, the exact 4-tap gather (JAX's ``impl="gather"``).

Inputs as JAX's, one numpy ``default_rng(0)`` for all shapes, in JAX's
order: an f32 frame ``rng.random((b, h, w, c))``, a smooth flow (the
model's hot call warps f32 frames by a 1/4-res upsampled flow): a coarse
(b, 9, 15, 2) grid times ``--flow-scale`` plus a (b, 1, 1, 2) global
shift times 3, upsampled to (h, w) by half-pixel bilinear interpolation
(``F.interpolate(..., align_corners=False)``, which equals JAX's
``jax.image.resize(..., "linear")`` when upsampling).

Timing as ``bench_conv``: one warm-up call (``compile_s``), then CUDA
events around ``n`` back-to-back calls, best of 3. JAX threaded a
dependence through both inputs of a ``lax.scan`` so that XLA could not
hoist the flow's preparation out of the loop; eager PyTorch hoists
nothing, so the calls take the same inputs.

One JSON line an impl and shape: JAX's keys ``impl``, ``shape``, ``ms``,
``hbm_bound_ms``, ``compile_s``, ``device`` (the card's ``nvidia-smi``
name and power limit, or "cpu"). ``hbm_bound_ms`` is
``utils/profiling.warp_roofline_ms``'s bytes over the H100's 3.35 TB/s
at the frame's real width, 4 bytes a channel for the f32 frame; JAX's
counted 2 bytes a channel at a TPU v5e's 819 GB/s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.ops.warp import backward_warp, warp_plain
from video_super_resolution_tpu_torch.tools.bench_conv import parse_shapes
from video_super_resolution_tpu_torch.tools.bench_dispatch import device_record, sync
from video_super_resolution_tpu_torch.tools.bench_roofline import best_s
from video_super_resolution_tpu_torch.utils.profiling import warp_roofline_ms

SHAPES = ((2, 544, 960, 4), (2, 136, 240, 32))     # (B, H, W, C)
IMPLS = ("kernel", "library")


def warp_library(img: torch.Tensor, flow: torch.Tensor,
                 padding_mode: str = "zeros") -> torch.Tensor:
    """``backward_warp``'s function by one library call: ``F.grid_sample``
    (bilinear, ``align_corners=True``) of the f32 image at the f32
    normalised grid ((x + u) * 2 / (W - 1) - 1, likewise for y), cast to
    img's dtype (contiguous NHWC). For H, W >= 2: at a size of 1 the grid
    cannot carry the flow."""
    b, h, w, c = img.shape
    ys = torch.arange(h, device=img.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
    fl = flow.to(torch.float32)
    grid = torch.stack([(xs + fl[..., 0]) * (2 / max(w - 1, 1)) - 1,
                        (ys + fl[..., 1]) * (2 / max(h - 1, 1)) - 1], dim=-1)
    out = F.grid_sample(img.permute(0, 3, 1, 2).to(torch.float32), grid,
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=True)
    return torch.empty(img.shape, dtype=img.dtype, device=img.device).copy_(
        out.permute(0, 2, 3, 1))


def warp_inputs(rng: np.random.Generator, shape: Sequence[int],
                flow_scale: float, dev: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX tool's frame and flow for ``shape``, f32 on ``dev``."""
    b, h, w, c = shape
    img = rng.random((b, h, w, c)).astype(np.float32)
    coarse = (rng.standard_normal((b, 9, 15, 2)) * flow_scale
              + rng.standard_normal((b, 1, 1, 2)) * 3.0).astype(np.float32)
    flow = F.interpolate(torch.from_numpy(coarse).permute(0, 3, 1, 2),
                         size=(h, w), mode="bilinear", align_corners=False)
    return (torch.from_numpy(img).to(dev),
            flow.permute(0, 2, 3, 1).contiguous().to(dev))


def run(impls: Sequence[str] = IMPLS, shapes: Sequence[Sequence[int]] = SHAPES,
        n: int = 32, flow_scale: float = 6.0, check: bool = False,
        device: api.Device = "cuda",
        emit: Callable[[str], None] = print) -> List[dict]:
    """Time each impl at each shape; each line is emitted as it is made.
    Returns the lines."""
    dev = api.resolve_device(device)
    for impl in impls:
        if impl not in IMPLS:
            raise ValueError(f"bench_warp: unknown impl {impl!r}, not in {IMPLS}")
    label = device_record(dev)
    rng = np.random.default_rng(0)
    lines = []
    for shape in shapes:
        b, h, w, c = shape
        img, flow = warp_inputs(rng, shape, flow_scale, dev)
        hbm_ms = warp_roofline_ms(b, h, w, c, img.element_size())["hbm_ms"]
        want = warp_plain(img, flow) if check else None
        for impl in impls:
            # looked up at each call: a caller may wrap the module's names
            fn = (lambda: backward_warp(img, flow)) if impl == "kernel" else (
                lambda: warp_library(img, flow))
            rec = {"impl": impl, "shape": list(shape)}
            t0 = time.perf_counter()
            got = fn()
            sync(dev)
            compile_s = time.perf_counter() - t0
            if want is not None:
                rec["max_abs_diff_vs_plain"] = (got - want).abs().max().item()
            del got
            per = best_s(fn, n, dev)
            rec.update({"ms": per * 1e3, "hbm_bound_ms": hbm_ms,
                        "compile_s": compile_s, "device": label})
            lines.append(rec)
            emit(json.dumps(rec))
        del img, flow, want
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impls", default=",".join(IMPLS))
    ap.add_argument("--shapes", default="2,544,960,4;2,136,240,32")
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--check", action="store_true",
                    help="each impl's output against the exact gather "
                         "(ops.warp.warp_plain)")
    ap.add_argument("--flow-scale", type=float, default=6.0,
                    help="std of the coarse flow grid (6.0 ~ 0.13 px/px "
                         "gradients; 1.5 ~ smooth serving content; 0 = "
                         "pure subpixel translation)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(args.impls.split(","), parse_shapes(args.shapes), args.n,
        args.flow_scale, args.check, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tracing and roofline helpers, the counterpart of the JAX package's
``utils/profiling.py``:

- ``profile_trace``: a context manager around steps that records them with
  ``torch.profiler`` (the host, and the device when it is a GPU) and
  writes a Chrome trace (``trace.json``) to a directory. The model's
  stages appear in it as ``record_function`` ranges (``flow``, ``depth``,
  ``warp``, ``encode``, ``fusion``, ``sr``; ``models/vsr.py``), the
  counterparts of the JAX package's ``jax.named_scope``s, and so does the
  serving entry (``api.py``): a clip's ``upscale_clip`` range holds a
  frame's ``upscale_clip.gather``, ``eval_step.upload``,
  ``eval_step.forward``, ``upscale_clip.stage`` (the frame's copy queued
  into a pinned buffer; on the CPU its write into the clip) and, after
  the next frame's forward where there is one, its
  ``upscale_clip.copy_back`` (the wait for the staged frame and its write
  into the clip). Beside them three counters, profiler or not:
  ``api.upscale_clip.frames`` (HR frames returned),
  ``api.upscale_clip.bytes_back`` (their bytes copied off the device) and
  ``api.upscale_clip.frames_staged`` (those that went through a pinned
  buffer). ``api.eval_step`` counts too: ``api.eval_step.calls``,
  ``api.eval_step.replays`` (calls whose forward replayed the model's CUDA
  graphs, ``models/graphs.py``) and ``api.eval_step.captures`` (calls that
  captured them first). A replay runs each graph inside the model's ranges
  it was captured in, and advances the kernel wrappers' ``launches`` by the
  launches it holds.
- ``correlation_roofline_ms`` / ``warp_roofline_ms`` /
  ``conv3x3_roofline_ms``: the least time an H100 SXM could take for the
  cost volume, the backward warp and the fused 3x3 conv, the larger of
  bytes over 3.35 TB/s and FLOP over the peak rate of the operands' type
  (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32), each input read
  and each output written once: the datasheet's rates, against which a
  share of speed-of-light is stated (the card's power limit beside it);
- ``roofline_report``: "measured vs floor" lines, the JAX package's
  lines letter for letter.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterator, Tuple

import torch

H100 = {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12, "f32_flops": 67e12}


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; write ``<log_dir>/trace.json`` at its end. Yields
    the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _roofline(flops: float, nbytes: float, dtype_bytes: int) -> Dict:
    peak = H100["bf16_flops"] if dtype_bytes == 2 else H100["f32_flops"]
    flop_ms = flops / peak * 1e3
    hbm_ms = nbytes / H100["hbm_bytes_per_s"] * 1e3
    return {"flops": flops, "bytes": nbytes, "hbm_ms": hbm_ms,
            "flop_ms": flop_ms, "floor_ms": max(hbm_ms, flop_ms),
            "bound_by": "operations" if flop_ms > hbm_ms else "bytes"}


def correlation_roofline_ms(b: int, h: int, w: int, c: int, d: int,
                            dtype_bytes: int = 4,
                            out_bytes: int = 4) -> Dict:
    """Cost volume of f1, f2 (B, H, W, C) over (2d+1)^2 displacements:
    read f1 and f2, write the (B, H, W, K) volume; 2 C FLOP a tap."""
    k = (2 * d + 1) ** 2
    return _roofline(2 * b * h * w * c * k,
                     2 * b * h * w * c * dtype_bytes + b * h * w * k * out_bytes,
                     dtype_bytes)


def warp_roofline_ms(b: int, h: int, w: int, c: int,
                     dtype_bytes: int = 4) -> Dict:
    """Bilinear warp of img (B, H, W, C) by an f32 flow: read img and flow,
    write the output; ~7 FLOP a channel (the 4-tap blend)."""
    return _roofline(7 * b * h * w * c,
                     2 * b * h * w * c * dtype_bytes + b * h * w * 2 * 4,
                     dtype_bytes)


def conv3x3_roofline_ms(b: int, h: int, w: int, cin: int, cout: int,
                        dtype_bytes: int, res_bytes: int = 0) -> Dict:
    """3x3 conv of x (B, H, W, Cin) to Cout channels, + f32 bias (+ a
    residual of ``res_bytes`` in all): read x, the (Cout, Cin, 3, 3)
    weight, the bias and the residual, write the output; 2 * 9 * Cin FLOP
    an output element."""
    return _roofline(2 * b * h * w * cout * 9 * cin,
                     (b * h * w * (cin + cout) + 9 * cin * cout) * dtype_bytes
                     + cout * 4 + res_bytes, dtype_bytes)


def roofline_report(measured_ms: Dict[str, Tuple[float, float]]) -> str:
    """Format 'measured vs floor' lines given {kernel_name: (ms, floor_ms)}."""
    lines = []
    for name, (ms, floor) in measured_ms.items():
        frac = floor / ms if ms > 0 else 0.0
        lines.append(f"{name}: {ms:.3f} ms measured, {floor:.3f} ms floor "
                     f"-> {100*frac:.0f}% of speed-of-light")
    return "\n".join(lines)

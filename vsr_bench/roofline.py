"""The H100's datasheet peaks and the least time a kernel could take on
it, frozen copies of ``video_super_resolution_tpu_torch/utils/profiling.py``
(``H100``, ``_roofline``, ``conv3x3_roofline_ms``, ``correlation_roofline_ms``,
``warp_roofline_ms``; ``conv_roofline_ms`` is the 3x3 one at any square
kernel size), so that a later change to the port cannot move the
yardstick. Each input is read and each output written once; the peak is
the operands' type's (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
f32), the bandwidth 3.35 TB/s: NVIDIA's H100 SXM datasheet, dense rates.

``flops`` counts the operations of one call of a function with
``torch.utils.flop_counter.FlopCounterMode`` on the meta device (matmuls
and convolutions, forward and backward), so nothing runs and no memory is
taken.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

H100 = {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12, "f32_flops": 67e12}


def _roofline(flops: float, nbytes: float, dtype_bytes: int) -> Dict:
    peak = H100["bf16_flops"] if dtype_bytes == 2 else H100["f32_flops"]
    flop_ms = flops / peak * 1e3
    hbm_ms = nbytes / H100["hbm_bytes_per_s"] * 1e3
    return {"flops": flops, "bytes": nbytes, "hbm_ms": hbm_ms,
            "flop_ms": flop_ms, "floor_ms": max(hbm_ms, flop_ms),
            "bound_by": "operations" if flop_ms > hbm_ms else "bytes"}


def correlation_roofline_ms(b: int, h: int, w: int, c: int, d: int,
                            dtype_bytes: int = 4, out_bytes: int = 4) -> Dict:
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


def conv_roofline_ms(b: int, h: int, w: int, cin: int, cout: int, k: int,
                     dtype_bytes: int, res_bytes: int = 0) -> Dict:
    """k x k conv of x (B, H, W, Cin) to Cout channels at an (H, W) output,
    + f32 bias (+ a residual of ``res_bytes`` in all): read x, the (Cout,
    Cin, k, k) weight, the bias and the residual, write the output;
    2 * k^2 * Cin FLOP an output element."""
    return _roofline(2 * b * h * w * cout * k * k * cin,
                     (b * h * w * (cin + cout) + k * k * cin * cout) * dtype_bytes
                     + cout * 4 + res_bytes, dtype_bytes)


def conv3x3_roofline_ms(b: int, h: int, w: int, cin: int, cout: int,
                        dtype_bytes: int, res_bytes: int = 0) -> Dict:
    """``conv_roofline_ms`` of a 3x3 conv."""
    return conv_roofline_ms(b, h, w, cin, cout, 3, dtype_bytes, res_bytes)


def flops(fn: Callable[[], object]) -> int:
    """Operations of one call of ``fn`` (which builds its own meta
    tensors), counted by ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def meta_params(shapes: Dict[str, tuple], grad: bool = False
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors of the parameters' shapes."""
    return {k: torch.empty(s, device="meta", requires_grad=grad)
            for k, s in shapes.items()}

"""Serving entry points of the port.

- ``build_model``: the VSR model with random weights from a seed (or load
  weights carried from the JAX package with ``weights.from_jax_params``).
- ``upscale_window``: (B, T, h, w, 3) LR window -> (B, 4h, 4w, 3).
- ``eval_step``: the same forward, f32 output clipped to [0, 1].
- ``estimate_and_align``: flow of each neighbor onto the reference and the
  warped neighbors.

They run on the CUDA device unless the caller passes ``device="cpu"``;
without a GPU a CUDA request raises instead of running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.models.common import init_params, pad_to_multiple
from video_super_resolution_tpu_torch.models.flow_net import FlowNet
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.ops.warp import backward_warp
from video_super_resolution_tpu_torch.runtime.dtypes import DTypePolicy

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the GPU "
                           "unless device='cpu' is passed")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_model(cfg: Optional[VSRConfig] = None, device: Device = "cuda",
                seed: int = 0) -> VSRModel:
    """The VSR model of ``cfg`` in its compute dtype, weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in eval mode on ``device``."""
    dev = resolve_device(device)
    cfg = cfg or VSRConfig()
    policy = DTypePolicy.from_strings(cfg.train.compute_dtype)
    model = VSRModel(cfg.model, dtype=policy.compute_dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def _device_of(model: torch.nn.Module) -> torch.device:
    return resolve_device(next(model.parameters()).device)


@torch.no_grad()
def upscale_window(model: VSRModel, window: torch.Tensor,
                   return_aux: bool = False):
    """(B, T, h, w, 3) LR window -> (B, h*scale, w*scale, 3) f32."""
    return model(window.to(_device_of(model)), return_aux=return_aux)


@torch.no_grad()
def eval_step(model: VSRModel, lr: torch.Tensor) -> torch.Tensor:
    """Forward, f32 prediction clipped to [0, 1]."""
    pred = model(lr.to(_device_of(model)))
    return pred.to(torch.float32).clamp(0.0, 1.0)


def build_flow_net(cfg: Optional[VSRConfig] = None, device: Device = "cuda",
                   seed: int = 0) -> FlowNet:
    """A standalone f32 FlowNet (for ``estimate_and_align``)."""
    dev = resolve_device(device)
    cfg = cfg or VSRConfig()
    m = cfg.model
    net = FlowNet(pyramid_channels=m.pyramid_channels,
                  estimator_channels=m.flow_estimator_channels,
                  context_channels=m.context_channels,
                  max_displacement=m.max_displacement, slope=m.lrelu_slope,
                  finest_level=m.flow_finest_level)
    init_params(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


@torch.no_grad()
def estimate_and_align(flow_net: FlowNet, ref: torch.Tensor,
                       neighbors: torch.Tensor, padding_mode: str = "zeros"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ref (B, H, W, 3), neighbors (B, N, H, W, 3) -> (flows (B, N, H, W, 2),
    warped neighbors (B, N, H, W, 3))."""
    dev = _device_of(flow_net)
    ref, neighbors = ref.to(dev), neighbors.to(dev)
    b, n, h0, w0, _ = neighbors.shape
    mult = 2 ** flow_net.levels
    ref_p, _ = pad_to_multiple(ref, mult)
    nbr_p, _ = pad_to_multiple(neighbors, mult)
    h, w = ref_p.shape[1:3]
    ref_rep = ref_p[:, None].expand(b, n, h, w, 3).reshape(b * n, h, w, 3)
    nbr_flat = nbr_p.reshape(b * n, h, w, 3)
    flows = flow_net(ref_rep, nbr_flat)
    warped = backward_warp(nbr_flat.contiguous(), flows.contiguous(),
                           padding_mode)
    flows = flows.reshape(b, n, h, w, 2)[:, :, :h0, :w0]
    warped = warped.reshape(b, n, h, w, 3)[:, :, :h0, :w0]
    return flows, warped

"""Losses: Charbonnier (robust L1), the training loss, and the MSE that the
train step logs as a PSNR proxy.

``sqrt((x - y)^2 + eps)`` averaged over all elements, eps the already
squared constant (1e-6 ~ (1e-3)^2), always in f32, as in the JAX package's
``ops/losses.py``.
"""

from __future__ import annotations

import torch


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    diff = pred.to(torch.float32) - target.to(torch.float32)
    return torch.sqrt(diff * diff + eps).mean()


def psnr_loss_proxy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE in f32 (for logging PSNR during training without metric code)."""
    diff = pred.to(torch.float32) - target.to(torch.float32)
    return (diff * diff).mean()

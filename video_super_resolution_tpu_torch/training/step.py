"""Train and eval steps, as the JAX package's ``training/step.py``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``: the
forward in the model's compute dtype, the Charbonnier loss in f32, the
gradients of the f32 master parameters (through the kernels' autograd
Functions), the global-norm clip and the Adam update (``TrainState``).
The metrics are 0-d device tensors, so a step does not wait for the
device; ``grad_norm`` is the norm before the clip.

The parallel modes of the JAX package (a mesh with more than one device)
are not ported: such a mesh raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import MeshConfig
from video_super_resolution_tpu_torch.ops.losses import charbonnier_loss, psnr_loss_proxy
from video_super_resolution_tpu_torch.training.state import TrainState

Step = Callable[[TrainState, dict], Tuple[TrainState, dict]]


def decode_batch(batch: dict, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lr, hr) of a batch on ``device``, both f32: a compact batch's uint8
    HR is divided by 255 there, an LR in another dtype (bf16) is cast."""
    lr = torch.as_tensor(batch["lr"]).to(device, non_blocking=True)
    hr = torch.as_tensor(batch["hr"]).to(device, non_blocking=True)
    if hr.dtype == torch.uint8:
        hr = hr.to(torch.float32) / 255.0
    if lr.dtype != torch.float32:
        lr = lr.to(torch.float32)
    return lr, hr


def _check_mesh(mesh: Optional[MeshConfig]) -> None:
    if mesh is not None and mesh.num_devices > 1:
        raise NotImplementedError(
            f"parallel training over {mesh.shape} is not ported yet")


def make_train_step(charbonnier_eps: float = 1e-6,
                    mesh: Optional[MeshConfig] = None) -> Step:
    """step(state, batch) -> (state, metrics). batch: {"lr": (B, T, h, w,
    3), "hr": (B, H, W, 3)}, numpy or tensors; the state is updated in
    place and returned."""
    _check_mesh(mesh)

    def step(state: TrainState, batch: dict):
        device = next(state.model.parameters()).device
        lr, hr = decode_batch(batch, device)
        pred = state.model(lr)
        loss = charbonnier_loss(pred, hr, charbonnier_eps)
        with torch.no_grad():
            mse = psnr_loss_proxy(pred, hr)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = state.apply_gradients()
        return state, {
            "loss": loss.detach(),
            "psnr_proxy": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "grad_norm": grad_norm,
        }

    return step


def make_multi_train_step(charbonnier_eps: float = 1e-6,
                          mesh: Optional[MeshConfig] = None) -> Step:
    """K steps a call: ``multi(state, batches)`` runs the train step over a
    leading stack axis ({"lr": (K, B, T, h, w, 3), "hr": (K, B, H, W, 3)})
    in order and returns the last step's metrics."""
    step = make_train_step(charbonnier_eps, mesh)

    def multi(state: TrainState, batches: dict):
        metrics = None
        for i in range(len(batches["lr"])):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()})
        return state, metrics

    return multi


def make_eval_step() -> Callable:
    """eval_step(model, lr) -> f32 prediction clipped to [0, 1]: the
    forward of ``api.eval_step``, without gradients."""
    return api.eval_step

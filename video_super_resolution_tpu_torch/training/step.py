"""Train and eval steps, as the JAX package's ``training/step.py``.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``: the
forward in the model's compute dtype, the Charbonnier loss in f32, the
gradients of the f32 master parameters (through the kernels' autograd
Functions), the global-norm clip and the Adam update (``TrainState``).
The metrics are 0-d device tensors, so a step does not wait for the
device; ``grad_norm`` is the norm before the clip.

With a mesh (``runtime.mesh``), one process a rank, each rank passes its
own batch (``data.loader.shard_train_batch``) and every rank reports the
global values, as JAX's GSPMD step does:

- data: after ``backward`` the gradients are averaged over the data axis,
  before the update, so that ``grad_norm`` and the clip are the global
  ones; the loss and the MSE are averaged with them (one all-reduce);
- space: the stages after the warp run on the rank's H strip
  (``parallel/spatial.py``) and the loss is taken on its HR rows, weighted
  by their share of the frame; gradients and metrics are summed over the
  space axis first;
- model: with a tensor-parallel trunk (``parallel/tensor.py``) the norm
  adds the sharded gradients of every model rank; otherwise the model axis
  replicates the step, as the time axis always does.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import MeshConfig
from video_super_resolution_tpu_torch.ops.losses import charbonnier_loss, psnr_loss_proxy
from video_super_resolution_tpu_torch.runtime.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_SPACE,
    Mesh,
    all_reduce_mean_,
    all_reduce_sum_,
    build_mesh,
)
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


def _sharded_step_fn(mesh: Mesh, charbonnier_eps: float):
    """loss_and_grads(state, lr, hr) -> (loss, mse, norm or None) with the
    gradients in ``.grad`` reduced over the mesh."""
    from video_super_resolution_tpu_torch.parallel.spatial import strip_forward
    from video_super_resolution_tpu_torch.parallel.tensor import sharded_parameters

    def run(state: TrainState, lr, hr):
        model = state.model
        pred, s = strip_forward(model, lr, mesh.index(AXIS_SPACE),
                                mesh.size(AXIS_SPACE))
        k = model.cfg.scale
        target = hr[:, k * s.r0:k * s.r1]
        share = (s.r1 - s.r0) / lr.shape[2]
        loss = charbonnier_loss(pred, target, charbonnier_eps) * share
        with torch.no_grad():
            mse = psnr_loss_proxy(pred, target) * share
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss.detach().reshape(1), mse.reshape(1)])
        all_reduce_sum_(flat, mesh, AXIS_SPACE)
        all_reduce_mean_(flat, mesh, AXIS_DATA)
        i = 0
        for p in params:
            p.grad.copy_(flat[i:i + p.numel()].view_as(p))
            i += p.numel()
        norm = None
        sharded = {id(p) for p in sharded_parameters(model)}
        if sharded:
            sq = [torch.stack(torch._foreach_norm(g)).square().sum()
                  for g in ([p.grad for p in params if id(p) in sharded],
                            [p.grad for p in params if id(p) not in sharded])]
            norm = (all_reduce_sum_(sq[0], mesh, AXIS_MODEL) + sq[1]).sqrt()
        return flat[-2], flat[-1], norm

    return run


def make_train_step(charbonnier_eps: float = 1e-6,
                    mesh: Union[None, MeshConfig, Mesh] = None) -> Step:
    """step(state, batch) -> (state, metrics). batch: {"lr": (B, T, h, w,
    3), "hr": (B, H, W, 3)}, numpy or tensors (with a mesh: this rank's
    local batch); the state is updated in place and returned.

    mesh: a ``runtime.mesh.Mesh``, or a ``MeshConfig``: one of more than
    one device is built from the initialized process group at the first
    step (``build_mesh`` raises, naming what is missing, without one), one
    of one device means no mesh."""
    resolved = []

    def sharded_fn(device):
        if not resolved:
            m = mesh
            if isinstance(m, MeshConfig):
                m = build_mesh(m, device) if m.num_devices > 1 else None
            resolved.append(None if m is None else
                            _sharded_step_fn(m, charbonnier_eps))
        return resolved[0]

    def step(state: TrainState, batch: dict):
        device = next(state.model.parameters()).device
        lr, hr = decode_batch(batch, device)
        sharded = sharded_fn(device)
        norm = None
        if sharded is not None:
            loss, mse, norm = sharded(state, lr, hr)
        else:
            pred = state.model(lr)
            loss = charbonnier_loss(pred, hr, charbonnier_eps)
            with torch.no_grad():
                mse = psnr_loss_proxy(pred, hr)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        grad_norm = state.apply_gradients(norm)
        return state, {
            "loss": loss.detach(),
            "psnr_proxy": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "grad_norm": grad_norm,
        }

    return step


def make_multi_train_step(charbonnier_eps: float = 1e-6,
                          mesh: Union[None, MeshConfig, Mesh] = None) -> Step:
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

"""Train state and optimizer, as the JAX package's ``training/state.py``
builds them with optax: Adam (AdamW with decoupled decay when
``weight_decay`` is set), eps 1e-8, on the f32 master parameters, after a
global-norm clip of the gradients, with a warmup + cosine, step or
constant learning-rate schedule, all held numerically against optax.

The optax conventions are kept: the schedule is read at the count of
updates made so far, so with warmup the first update has learning rate 0;
the clip scales the gradients by ``grad_clip / norm`` only when the norm
is not below ``grad_clip`` (no epsilon, unlike
``torch.nn.utils.clip_grad_norm_``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import TrainConfig, VSRConfig

Schedule = Callable[[int], float]


def make_schedule(cfg: TrainConfig) -> Schedule:
    """Learning rate as a plain function of the update count (optax's
    ``join_schedules([linear warmup from 0, base], [warmup_steps])``)."""
    lr = cfg.lr
    if cfg.lr_schedule == "const":
        def base(count):
            return lr
    elif cfg.lr_schedule == "step":
        bounds = [i * cfg.lr_step_every
                  for i in range(1, max(1, cfg.steps // cfg.lr_step_every) + 1)]

        def base(count):
            return lr * cfg.lr_step_gamma ** sum(count >= b for b in bounds)
    elif cfg.lr_schedule == "cosine":
        decay = max(1, cfg.steps - cfg.warmup_steps)

        def base(count):
            cos = 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))
            return lr * ((1 - 0.01) * cos + 0.01)
    else:
        raise ValueError(f"bad lr_schedule {cfg.lr_schedule}")
    warm = cfg.warmup_steps
    if warm <= 0:
        return base

    def schedule(count):
        if count < warm:
            return lr * count / warm
        return base(count - warm)
    return schedule


class Adam(torch.optim.Optimizer):
    """optax's ``adam`` (``adamw`` with a weight decay) on torch parameters,
    in multi-tensor (foreach) ops:

        mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2
        u  = mu / c1 / (sqrt(nu / c2) + eps) (+ weight_decay * p)
        p -= lr * u,   c_i = 1 - b_i^count

    with the bias corrections c_i computed in f32, as optax computes them:
    torch's own Adam computes them in f64, and at count 1 with b2 = 0.999
    the two differ by 1.3e-5 relative, which moves the update as much."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
            count = self.state[params[0]]["step"]
            grads = [p.grad for p in params]
            mu = [self.state[p]["exp_avg"] for p in params]
            nu = [self.state[p]["exp_avg_sq"] for p in params]
            b1, b2 = group["betas"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            c1, c2 = (float(1 - torch.tensor(b, dtype=torch.float32) ** count)
                      for b in (b1, b2))
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mu, c1)
            torch._foreach_div_(upd, den)
            if group["weight_decay"]:
                torch._foreach_add_(upd, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, upd, alpha=-group["lr"])


def make_optimizer(params: Iterable[nn.Parameter], cfg: TrainConfig) -> Adam:
    """Adam (AdamW when ``weight_decay`` is set), eps 1e-8; the learning
    rate is set before each update from the schedule (``TrainState``)."""
    return Adam(params, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2),
                eps=1e-8, weight_decay=cfg.weight_decay)


@dataclasses.dataclass
class TrainState:
    """The model (f32 master parameters, compute dtype inside), its
    optimizer, the schedule, the clip and the number of updates made."""

    model: nn.Module
    optimizer: Adam
    schedule: Schedule
    grad_clip: float = 0.0
    step: int = 0

    def apply_gradients(self, norm: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """One update from the parameters' ``.grad``: global-norm clip,
        then Adam at ``schedule(step)``. Returns the pre-clip global norm,
        a 0-d f32 tensor on the parameters' device (no host sync): the
        norm of these gradients, or ``norm`` when the caller gives it (the
        norm over every rank's shard under tensor parallelism)."""
        grads = [p.grad for g in self.optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
        if self.grad_clip:
            clip = torch.where(norm < self.grad_clip, 1.0,
                               self.grad_clip / norm)
            torch._foreach_mul_(grads, clip)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return norm


def create_train_state(cfg: VSRConfig, device: api.Device = "cuda",
                       seed: Optional[int] = None) -> TrainState:
    """The VSR model of ``cfg`` with random weights from ``seed`` (default
    ``cfg.train.seed``) on ``device``, and its optimizer at step 0."""
    model = api.build_model(cfg, device,
                            cfg.train.seed if seed is None else seed)
    model.train()
    return TrainState(model, make_optimizer(model.parameters(), cfg.train),
                      make_schedule(cfg.train), cfg.train.grad_clip)

"""Plain PyTorch reference of the train step: a reference's forward (the
run's, such as ``reference/vsr.py``'s), the Charbonnier loss, autograd's
gradients, the global-norm clip and Adam with its learning-rate schedule,
all f32.

The optimizer follows optax's conventions, which the configuration's
training states: Adam with eps 1e-8 outside the square root, bias
corrections computed in f32, the learning rate read at the count of
updates made so far (so with warm-up the first update has rate 0), a
linear warm-up from 0 then a cosine decay to 1 % (or a step or constant
rate), and a clip that scales the gradients by clip / norm only when the
norm is not below the clip.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float
                ) -> torch.Tensor:
    """mean(sqrt((pred - target)^2 + eps)), eps already squared."""
    d = pred - target
    return torch.sqrt(d * d + eps).mean()


def learning_rate(t: dict, count: int) -> float:
    """The schedule of train config ``t`` after ``count`` updates."""
    lr, warm = t["lr"], t["warmup_steps"]
    if warm > 0 and count < warm:
        return lr * count / warm
    count -= max(warm, 0)
    kind = t["lr_schedule"]
    if kind == "const":
        return lr
    if kind == "step":
        bounds = [i * t["lr_step_every"]
                  for i in range(1, max(1, t["steps"] // t["lr_step_every"]) + 1)]
        return lr * t["lr_step_gamma"] ** sum(count >= b for b in bounds)
    if kind == "cosine":
        decay = max(1, t["steps"] - warm)
        cos = 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))
        return lr * ((1 - 0.01) * cos + 0.01)
    raise ValueError(f"unknown lr_schedule {kind}")


def steps(forward: Callable, p0: Dict[str, torch.Tensor], m: dict, t: dict,
          batches: List[dict], ops=None) -> dict:
    """Train ``forward(p, m, lr, ops)`` (a reference's) from the parameters
    ``p0`` on ``batches`` (each {"lr": (B, T, h, w, 3), "hr": (B, H, W, 3)}
    f32 tensors on p0's device), one update a batch. Returns the loss of
    each step, the gradient of the first step as Adam received it (after
    the clip), and each parameter's change over all the steps."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    b1, b2 = t["adam_b1"], t["adam_b2"]
    eps, wd = 1e-8, t["weight_decay"]
    losses, first_grad = [], None
    for count, batch in enumerate(batches):
        pred = forward(p, m, batch["lr"], ops)
        loss = charbonnier(pred, batch["hr"], t["charbonnier_eps"])
        grads = torch.autograd.grad(loss, list(p.values()))
        g = dict(zip(p.keys(), grads))
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum((v.double() ** 2).sum() for v in g.values())
                          ).float()
        if t["grad_clip"] and float(norm) >= t["grad_clip"]:
            g = {k: v * (t["grad_clip"] / norm) for k, v in g.items()}
        if first_grad is None:
            first_grad = {k: v.detach().clone() for k, v in g.items()}
        n = count + 1
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
        rate = learning_rate(t, count)
        with torch.no_grad():
            for k in p:
                mu[k] = b1 * mu[k] + (1 - b1) * g[k]
                nu[k] = b2 * nu[k] + (1 - b2) * g[k] * g[k]
                u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                if wd:
                    u = u + wd * p[k]
                p[k] -= rate * u
    change = {k: (p[k].detach() - p0[k]) for k in p}
    return {"losses": losses, "first_grad": first_grad, "change": change}

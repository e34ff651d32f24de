"""Seeded weights, made on the device in a few large calls.

The init rule is a frozen copy of
``video_super_resolution_tpu_torch/models/common.py:init_params``:
LeCun-normal kernels (std 1/sqrt(fan_in)) and normal biases of std 0.01,
f32 (the model keeps f32 parameters and rounds them to its compute dtype
itself). One normal draw holds every kernel and one every bias, from a
``torch.Generator`` on the device seeded with the run's seed. A reference
whose published init differs scales the draw (``for_run``).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

BIAS_STD = 0.01


def for_run(run) -> Dict[str, torch.Tensor]:
    """The run's weights: every parameter its reference's ``param_shapes``
    names at the run's configuration, drawn from the run's seed on its
    device, then each tensor that the reference's ``init_scale``, where it
    has one, names multiplied by its factor."""
    ref = run.reference
    out = make(ref.param_shapes(run.model), run.seed, run.device)
    scale = getattr(ref, "init_scale", None)
    factors = scale(run.model) if scale is not None else {}
    missing = sorted(set(factors) - set(out))
    if missing:
        raise ValueError(f"{ref.__name__}.init_scale names parameters that "
                         f"param_shapes does not: {missing[:5]}")
    for name, factor in factors.items():
        out[name].mul_(factor)
    return out


def make(shapes: Dict[str, tuple], seed: int, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    """Name -> f32 tensor on ``device`` for every shape in ``shapes``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    out = {}
    for rank4 in (True, False):
        names = [n for n, s in shapes.items() if (len(s) == 4) == rank4]
        sizes = [math.prod(shapes[n]) for n in names]
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        if rank4:
            std = torch.tensor([1.0 / math.sqrt(math.prod(shapes[n][1:]))
                                for n in names], device=device)
            flat *= torch.repeat_interleave(
                std, torch.tensor(sizes, device=device))
        else:
            flat *= BIAS_STD
        for n, part in zip(names, torch.split(flat, sizes)):
            out[n] = part.view(shapes[n])
    return out


@torch.no_grad()
def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters by name; the two must
    hold the same names with the same shapes."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            f"the program's parameters differ from the reference's: only "
            f"the program has {sorted(set(params) - set(weights))[:5]}, only "
            f"the reference {sorted(set(weights) - set(params))[:5]}")
    bad = [n for n in params if tuple(params[n].shape) != tuple(weights[n].shape)]
    if bad:
        raise ValueError(f"parameter shapes differ: {bad[:5]}")
    names = list(params)
    torch._foreach_copy_([params[n] for n in names], [weights[n] for n in names])

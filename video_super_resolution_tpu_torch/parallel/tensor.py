"""Tensor parallelism of the SR trunk over the "model" axis, as the JAX
package's ``parallel/tensor.py``: Megatron channel sharding of each wide
ResBlock (conv1 C -> 2C, conv2 2C -> C).

- ``ResBlock_i.ConvLReLU_0`` (conv1) is split on its output channels:
  weight and bias on OIHW dim 0;
- ``ResBlock_i.Conv_0`` (conv2) is split on its input channels: weight on
  OIHW dim 1; its bias stays whole;
- every other parameter is replicated (``trunk_param_plan``).

A rank's block (``TPResBlock``) runs conv1 at Cout = 2C/n and conv2 at
Cin = 2C/n through the port's own conv kernel, conv2 with no bias and no
residual, its partial sum cast to f32; the partial sums are all-reduced
over the model group (one all-reduce a block), and the bias and the skip
are added once, after it. (The unsharded ``ResBlock`` adds the skip in
conv2's epilogue: on every rank it would count n times.) In bf16 each
partial sum is rounded to bf16 by the kernel (its output dtype is its
input's) before the f32 reduction.

The JAX TP program forces the XLA conv because GSPMD cannot partition a
Pallas call; the port has no such limit. The gradients of the sharded
parameters stay sharded through Adam; those of the replicated ones come out
the same on every model rank (Megatron's f and g,
``runtime.mesh.copy_to_model_group`` / ``reduce_from_model_group``).
``shard_params_tp`` builds a sharded copy and leaves the model it was
given, and its prepared-weight caches, as they were.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Callable, Dict, Iterable, List, Optional

import torch
from torch import nn

from video_super_resolution_tpu_torch.models.common import (
    ConvLReLU,
    ResBlock,
    RoutedConv,
    _Conv3x3,
)
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.runtime.mesh import (
    AXIS_MODEL,
    Mesh,
    copy_to_model_group,
    reduce_from_model_group,
)

_COUT = re.compile(r"^sr_head\.ResBlock_\d+\.ConvLReLU_0\.(weight|bias)$")
_CIN = re.compile(r"^sr_head\.ResBlock_\d+\.Conv_0\.weight$")


def trunk_param_plan(keys: Iterable[str]) -> Dict[str, Optional[int]]:
    """state_dict key -> the dim it is split on over the model axis (None:
    replicated)."""
    return {k: 0 if _COUT.match(k) else (1 if _CIN.match(k) else None)
            for k in keys}


class TPResBlock(nn.Module):
    """One model rank's share of a wide ResBlock: conv1's output channels
    [m k, (m + 1) k) and conv2's same input channels, k = 2C / n, and
    conv2's whole bias. Parameter names are the ResBlock's."""

    def __init__(self, block: ResBlock, mesh: Mesh):
        super().__init__()
        conv1, conv2 = block.ConvLReLU_0, block.Conv_0
        c, mid = conv1.weight.shape[1], conv1.weight.shape[0]
        n = mesh.size(AXIS_MODEL)
        if mid % n:
            raise ValueError(f"trunk width {mid} not divisible by model "
                             f"axis {n}")
        self.mesh = mesh
        self.ConvLReLU_0 = ConvLReLU(c, mid // n, slope=conv1.slope,
                                     dtype=conv1.dtype)
        self.Conv_0 = RoutedConv(mid // n, c, dtype=conv2.dtype,
                                 out_dtype=torch.float32)

    def sharded_parameters(self) -> List[nn.Parameter]:
        return [self.ConvLReLU_0.weight, self.ConvLReLU_0.bias,
                self.Conv_0.weight]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ConvLReLU_0(copy_to_model_group(x, self.mesh))
        conv2 = self.Conv_0
        part = conv2.conv(h, conv2.dtype, 1.0, with_bias=False)
        y = reduce_from_model_group(part.to(conv2.out_dtype), self.mesh)
        return (y + conv2.bias + x.to(torch.float32)).to(h.dtype)


def shard_params_tp(model: VSRModel, mesh: Mesh) -> VSRModel:
    """A copy of ``model`` with each SR-trunk ResBlock replaced by this
    rank's ``TPResBlock``, holding this rank's slices of the parameters
    ``trunk_param_plan`` splits; ``model`` is left as it was."""
    tp = copy.deepcopy(model)
    for m in tp.modules():
        if isinstance(m, _Conv3x3):
            m._prepared = {}
    head = tp.sr_head
    for i in range(head.blocks):
        name = f"ResBlock_{i}"
        head.add_module(name, TPResBlock(getattr(head, name), mesh))
    n, m = mesh.size(AXIS_MODEL), mesh.index(AXIS_MODEL)
    local = {}
    for k, v in model.state_dict().items():
        dim = trunk_param_plan([k])[k]
        if dim is not None:
            v = v.chunk(n, dim=dim)[m]
        local[k] = v
    tp.load_state_dict(local, strict=True)
    return tp.to(mesh.device)


def sharded_parameters(model: nn.Module) -> List[nn.Parameter]:
    """The parameters of ``model`` that are split over the model axis."""
    return [p for m in model.modules() if isinstance(m, TPResBlock)
            for p in m.sharded_parameters()]


def make_tp_forward(model: VSRModel, mesh: Mesh) -> Callable:
    """forward(window) -> HR frame, the same on every model rank: the
    forward of ``shard_params_tp(model, mesh)`` without gradients (the
    sharded copy is the function's ``model`` attribute)."""
    tp = shard_params_tp(model, mesh)

    @torch.no_grad()
    def tp_forward(window: torch.Tensor) -> torch.Tensor:
        return tp(window.to(mesh.device))

    tp_forward.model = tp
    return tp_forward


def shard_train_state_tp(state, mesh: Mesh):
    """A train state (``training.state.TrainState``) whose model is
    ``shard_params_tp`` of ``state.model``, with a new optimizer over its
    parameters; ``state`` must not have taken a step."""
    from video_super_resolution_tpu_torch.training.state import Adam

    if state.optimizer.state:
        raise ValueError("shard_train_state_tp: the state has optimizer "
                         "moments; shard a state that has taken no step")
    model = shard_params_tp(state.model, mesh).train()
    group = state.optimizer.param_groups[0]
    opt = Adam(model.parameters(), **{k: group[k] for k in
                                      ("lr", "betas", "eps", "weight_decay")})
    return dataclasses.replace(state, model=model, optimizer=opt)


def make_tp_train_step(mesh: Mesh, charbonnier_eps: float = 1e-6) -> Callable:
    """step(state, batch) on a (data x model) mesh for a state from
    ``shard_train_state_tp``: the per-block all-reduce over the model axis
    (forward, and its transpose backward), the gradient mean over the data
    axis, and the global gradient norm over the sharded and the replicated
    parameters (``training.step.make_train_step`` with the mesh)."""
    from video_super_resolution_tpu_torch.training.step import make_train_step

    return make_train_step(charbonnier_eps, mesh=mesh)

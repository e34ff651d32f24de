"""Torch ``state_dict`` -> port ``state_dict`` import, the counterpart of
the JAX package's ``training/import_torch.py``.

The port keeps torch's layouts, so the conversions are few:

- Conv2d: OIHW, as it is; bias as it is.
- ConvTranspose2d: (I, O, kH, kW) -> OIHW with the taps flipped (the
  gradient-vs-correlation convention), for completeness.
- Linear: (out, in), as it is.

The reference checkpoint's module names are unknown, so the mapping is
data-driven: ``import_state_dict`` takes an explicit {torch module prefix:
port module path} table; ``import_by_order`` zips (weight, bias) pairs onto
the port's conv modules in the order the JAX package zips them onto flax
modules (flax's sorted param paths, where ``ConvLReLU_10`` comes before
``ConvLReLU_2``), so both packages assign the same tensor to the same
parameter.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from video_super_resolution_tpu_torch.weights import flax_path


def conv_transpose_kernel_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """torch ConvTranspose2d weight (I, O, kH, kW) -> OIHW, taps flipped."""
    return w.permute(1, 0, 2, 3).flip(2, 3)


def _param(sd: Dict[str, torch.Tensor], key: str, value: torch.Tensor,
           what: str) -> None:
    if key not in sd:
        raise ValueError(f"{what}: the model has no parameter {key}")
    value = torch.as_tensor(value).detach()
    if tuple(value.shape) != tuple(sd[key].shape):
        raise ValueError(f"{what} -> {key}: shape {tuple(value.shape)} vs "
                         f"{tuple(sd[key].shape)}")
    sd[key] = value.to(sd[key].dtype).clone()


def _state(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def import_state_dict(state_dict: Mapping[str, Any],
                      key_map: Mapping[str, str],
                      model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of ``model``'s state_dict with torch tensors written in.

    key_map: torch module prefix (e.g. ``"net.conv1"``) -> port module path
    (e.g. ``"sr_head.Conv_1"``). For each prefix, ``.weight`` (4-D conv or
    2-D linear) is written to the module's ``weight`` and, where both sides
    have one, ``.bias`` to its ``bias``; a missing module or a shape that
    differs raises ValueError."""
    sd = _state(model)
    for prefix, path in key_map.items():
        w = torch.as_tensor(state_dict[prefix + ".weight"])
        if w.ndim not in (2, 4):
            raise ValueError(f"{prefix}: unsupported weight ndim {w.ndim}")
        _param(sd, path + ".weight", w, prefix)
        if prefix + ".bias" in state_dict and path + ".bias" in sd:
            _param(sd, path + ".bias", state_dict[prefix + ".bias"], prefix)
    return sd


def conv_modules_in_flax_order(model: nn.Module) -> List[str]:
    """Paths of the port modules that are flax modules with a ``kernel``, in
    flax's sorted-path order: the order of the JAX package's
    ``flatten_params``. The two_stage head's upsample parameters are raw
    leaves of the head in flax, not modules, so it skips them as JAX does."""
    paths = []
    for key in model.state_dict():
        fp = flax_path(key)
        if fp[-1] == "kernel":
            paths.append((fp[:-1], key[:-len(".weight")]))
    return [path for _, path in sorted(paths)]


def import_by_order(torch_tensors: Sequence[Tuple[Any, Optional[Any]]],
                    model: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of ``model``'s state_dict with (weight, bias) pairs zipped onto
    its conv modules in flax's sorted-path order; the counts and each shape
    must match. For oracle tests where both sides define modules in the
    same order."""
    sd = _state(model)
    paths = conv_modules_in_flax_order(model)
    if len(torch_tensors) != len(paths):
        raise ValueError(f"{len(torch_tensors)} torch modules vs {len(paths)} "
                         f"port modules")
    for (w, b), path in zip(torch_tensors, paths):
        _param(sd, path + ".weight", w, path)
        if b is not None and path + ".bias" in sd:
            _param(sd, path + ".bias", b, path)
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch .pth/.pt checkpoint on the CPU (``weights_only``); a
    ``{"state_dict": ...}`` wrapper is unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)

"""Carry weights between the JAX package's flax param tree and the port.

The port names its submodules after the flax modules (``flow_net``,
``FeaturePyramid_0``, ``estimator_l4``, ``ScoreConv_0``, ``subpixel_conv``,
...), so a flax leaf path maps to a state_dict key by a path rewrite:

    ("flow_net", "FeaturePyramid_0", "ConvLReLU_3", "kernel")
        -> "flow_net.FeaturePyramid_0.ConvLReLU_3.weight"   (HWIO -> OIHW)

Mapping is by name, never by order: flax sorts ``ConvLReLU_10`` before
``ConvLReLU_2``, so any zip over sorted leaves would mis-assign DepthNet's
thirteen convs.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch

from video_super_resolution_tpu_torch.config import ModelConfig, VSRConfig


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _key(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    if leaf not in ("kernel", "bias"):
        raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    return ".".join(mods + ["weight" if leaf == "kernel" else "bias"])


def _expected_shapes(target: Union[ModelConfig, VSRConfig, torch.nn.Module]
                     ) -> Dict[str, Tuple[int, ...]]:
    if isinstance(target, torch.nn.Module):
        module = target
    else:
        from video_super_resolution_tpu_torch.models.vsr import VSRModel

        cfg = target.model if isinstance(target, VSRConfig) else target
        with torch.device("meta"):
            module = VSRModel(cfg)
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def from_jax_params(params: Mapping[str, Any],
                    target: Union[ModelConfig, VSRConfig, torch.nn.Module]
                    ) -> Dict[str, torch.Tensor]:
    """flax params (nested dict of arrays) -> a port state_dict: the
    VSRModel's for a config, or ``target``'s own for a port module whose
    flax counterpart produced ``params``.

    Every leaf is consumed exactly once; an unknown name, a shape mismatch
    or a port parameter left without a leaf raises ValueError."""
    want = _expected_shapes(target)
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(params):
        key = _key(path)
        arr = np.asarray(leaf, dtype=np.float32)
        if path[-1] == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: kernel ndim {arr.ndim}")
            arr = arr.transpose(3, 2, 0, 1)                 # HWIO -> OIHW
        if key not in want:
            raise ValueError(f"flax leaf {'/'.join(path)} has no port "
                             f"parameter {key}")
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        if arr.shape != want[key]:
            raise ValueError(f"{key}: flax shape {arr.shape} vs port "
                             f"{want[key]}")
        out[key] = torch.tensor(arr)
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"port parameters without a flax leaf: {missing}")
    return out


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse: a port state_dict -> flax params (nested dict of numpy,
    HWIO kernels)."""
    tree: Dict[str, Any] = {}
    for key, t in state_dict.items():
        *mods, leaf = key.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0)                 # OIHW -> HWIO
            leaf = "kernel"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree

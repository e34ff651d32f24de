"""Carry weights between the JAX package's flax param tree and the port.

The port names its submodules after the flax modules (``flow_net``,
``FeaturePyramid_0``, ``estimator_l4``, ``ScoreConv_0``, ``subpixel_conv``,
...), so a flax leaf path maps to a state_dict key by a path rewrite:

    ("flow_net", "FeaturePyramid_0", "ConvLReLU_3", "kernel")
        -> "flow_net.FeaturePyramid_0.ConvLReLU_3.weight"   (HWIO -> OIHW)

The two_stage SR head keeps its upsample parameters as raw leaves of the
head (``sr_head/upsample_{u}_kernel``, ``sr_head/upsample_{u}_bias``);
they map to the port's ``sr_head.upsample_{u}`` conv module's ``weight``
and ``bias``.

Mapping is by name, never by order: flax sorts ``ConvLReLU_10`` before
``ConvLReLU_2``, so any zip over sorted leaves would mis-assign DepthNet's
thirteen convs.
"""

from __future__ import annotations

import re
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


# the two_stage head's raw leaves, e.g. ("sr_head", "upsample_0_kernel")
_RAW_LEAF = re.compile(r"^(upsample_\d+)_(kernel|bias)$")
_RAW_MODULE = re.compile(r"^upsample_\d+$")


def _split(path: Tuple[str, ...]) -> Tuple[list, str]:
    """(module path, "kernel" | "bias") of a flax leaf path."""
    *mods, leaf = path
    raw = _RAW_LEAF.match(leaf)
    if raw:
        return mods + [raw.group(1)], raw.group(2)
    if leaf not in ("kernel", "bias"):
        raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    return mods, leaf


def _key(path: Tuple[str, ...]) -> str:
    mods, leaf = _split(path)
    return ".".join(mods + ["weight" if leaf == "kernel" else "bias"])


def flax_path(key: str) -> Tuple[str, ...]:
    """The flax leaf path of a port state_dict key (``_key``'s inverse)."""
    *mods, leaf = key.split(".")
    leaf = "kernel" if leaf == "weight" else leaf
    if mods and _RAW_MODULE.match(mods[-1]):
        return tuple(mods[:-1]) + (f"{mods[-1]}_{leaf}",)
    return tuple(mods) + (leaf,)


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
        if _split(path)[1] == "kernel":
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
        *mods, leaf = flax_path(key)
        arr = t.detach().to("cpu", torch.float32).numpy()
        if key.endswith(".weight"):
            arr = arr.transpose(2, 3, 1, 0)                 # OIHW -> HWIO
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree

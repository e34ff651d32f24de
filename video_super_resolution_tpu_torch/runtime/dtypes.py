"""Dtype policy: bf16 compute, f32 params and heads.

Every module takes its compute dtype from this policy; a config with
``train.compute_dtype="float32"`` is the all-f32 path that parity checks
run.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # accumulation / loss always f32

    @classmethod
    def from_strings(cls, compute: str, param: str = "float32") -> "DTypePolicy":
        return cls(compute_dtype=_DTYPES[compute], param_dtype=_DTYPES[param])

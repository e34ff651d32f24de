"""Debug tooling, the counterpart of the JAX package's ``utils/debug.py``:

- ``find_nonfinite``: which tensors of a state_dict (or any nested dict of
  tensors) hold NaN or Inf, with their counts.
- ``checked_apply``: run a module's forward with a forward hook on every
  submodule and raise ``NonFiniteError`` naming the first module, in
  execution order, whose output holds NaN or Inf (the counterpart of
  ``checkify``'s float checks, at module granularity). Each hook waits for
  the device, so it is for triage, not for timing.

The JAX package's ``interpret_all_kernels`` has no switch here: each
kernel's plain PyTorch version is its oracle, run for CPU tensors and held
against the kernel on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch
from torch import nn


class NonFiniteError(FloatingPointError):
    """A module's output held NaN or Inf."""


def find_nonfinite(tree: Mapping[str, Any], prefix: str = ""
                   ) -> Dict[str, Tuple[int, int]]:
    """{dotted key: (num_nan, num_inf)} for the floating-point tensors of
    ``tree`` (nested dicts allowed) that hold non-finite values."""
    bad = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            bad.update(find_nonfinite(v, key + "."))
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            n_nan = int(torch.isnan(v).sum())
            n_inf = int(torch.isinf(v).sum())
            if n_nan or n_inf:
                bad[key] = (n_nan, n_inf)
    return bad


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, Mapping):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


def checked_apply(model: nn.Module) -> Callable:
    """fn(*args, **kw) -> model(*args, **kw); raises NonFiniteError naming
    the first module whose output is not finite (the model itself, by its
    class name, when only its own code outside submodules made it so)."""

    def check(name):
        def hook(module, inputs, output):
            for t in _tensors(output):
                if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                    raise NonFiniteError(
                        f"non-finite output of {name} "
                        f"({type(module).__name__}, shape {tuple(t.shape)})")
        return hook

    def run(*args, **kw):
        handles = [m.register_forward_hook(check(n or type(model).__name__))
                   for n, m in model.named_modules()]
        try:
            return model(*args, **kw)
        finally:
            for h in handles:
                h.remove()

    return run

"""Checkpoints of the train state: ``torch.save`` of the model's and the
optimizer's state, the step and the config JSON, one file a step
(``ckpt_<step>.pt``), written to a temporary file and renamed into place,
so a crash mid-save leaves the previous checkpoints intact. The newest
``keep`` are kept.

The config is ``VSRConfig.to_json()``, field for field the JAX package's
format, so either package reads it. Saves are synchronous (the JAX package
saves asynchronously with Orbax).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.training.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             config: Optional[VSRConfig] = None) -> None:
        blob = {"step": step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "config": None if config is None else config.to_json()}
        tmp = self.path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self.path(old))

    def _load(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True), step

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[Optional[TrainState], Optional[int]]:
        """Load the latest (or given) step into ``state`` (its model and
        optimizer, in place, on their device); (None, None) if there is
        none."""
        blob, step = self._load(step)
        if blob is None:
            return None, None
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = blob["step"]
        return state, step

    def restore_config(self, step: Optional[int] = None
                       ) -> Optional[VSRConfig]:
        blob, _ = self._load(step)
        if blob is None or blob["config"] is None:
            return None
        return VSRConfig.from_json(blob["config"])

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between saves."""

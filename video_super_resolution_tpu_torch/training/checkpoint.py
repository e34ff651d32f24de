"""Checkpoints of the train state: ``torch.save`` of the model's and the
optimizer's state, the step and the config JSON, one file a step
(``ckpt_<step>.pt``), written to a temporary file and renamed into place,
so a crash mid-save leaves the previous checkpoints intact. The newest
``keep`` are kept.

Saves are asynchronous, as the JAX package's Orbax manager's by default
(``enable_async_checkpointing``): ``save`` copies the state to host memory
before it returns, so the caller may go on updating the parameters, and a
writer thread does the write, the rename and the retention. ``wait`` joins
the writer; a second ``save``, ``steps``, ``restore`` and ``close`` wait
for the one before. An error in the writer is raised by the next of them,
never dropped.

The config is ``VSRConfig.to_json()``, field for field the JAX package's
format, so either package reads it.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, List, Optional, Tuple

import torch

from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.training.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def host_copy(obj: Any) -> Any:
    """``obj`` with every tensor copied to host memory (a new tensor even
    for one already on the CPU), through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> List[int]:
        """The saved steps, the pending save's included (waits for it)."""
        self.wait()
        return self._on_disk()

    def _on_disk(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             config: Optional[VSRConfig] = None) -> None:
        """Copy the state to host memory; the writer thread writes it."""
        self.wait()
        blob = {"step": step,
                "model": host_copy(state.model.state_dict()),
                "optimizer": host_copy(state.optimizer.state_dict()),
                "config": None if config is None else config.to_json()}
        self._writer = threading.Thread(target=self._run, args=(step, blob),
                                        name=f"ckpt-{step}", daemon=True)
        self._writer.start()

    def _run(self, step: int, blob: dict) -> None:
        try:
            self._write(step, blob)
        except Exception as e:     # raised to the caller by wait()
            self._error = e

    def _write(self, step: int, blob: dict) -> None:
        tmp = self.path(step) + ".tmp"
        torch.save(blob, tmp)
        os.replace(tmp, self.path(step))
        for old in self._on_disk()[:-self.keep] if self.keep > 0 else []:
            os.remove(self.path(old))

    def wait(self) -> None:
        """Block until the pending save is written; raise its error if it
        failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("checkpoint write failed") from err

    def _load(self, step: Optional[int]):
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        self.wait()
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

    def close(self) -> None:
        """Wait for the pending save."""
        self.wait()

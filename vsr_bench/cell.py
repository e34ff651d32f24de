"""The records a run passes between the harness and a traffic kind."""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class Run:
    """What a kind needs to run a cell: its entries and files, the plain
    reference its configuration names, the seed, the device, the weights
    and what the run's program is."""

    name: str
    cell: dict
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # limits/<cell>.json
    seed: int
    device: torch.device
    reference: types.ModuleType      # reference/<config's "reference">.py
    weights: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # "port", or "control": the reference at the next lower precision in
    # the port's place (for the readings of the correctness limits)
    program: str = "port"
    fault: Optional[str] = None      # a planted fault, for the harness tests
    # seconds of each phase of set-up and check, for the run's stderr
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    # The configuration file's ``vsr_config`` holds the port's configuration
    # of whatever architecture the file's ``reference`` names: its ``model``
    # section sizes the architecture (the reference's ``param_shapes`` and
    # ``forward`` read it), its ``train`` section the compute type and the
    # optimizer.
    @property
    def model(self) -> dict:
        return self.config["vsr_config"]["model"]

    @property
    def train(self) -> dict:
        return self.config["vsr_config"]["train"]


@dataclasses.dataclass
class Window:
    """What a kind's measured window did: ``units`` of work (frames or
    steps) over ``seconds``, the requests it attempted and failed, its
    end-to-end metrics, and what the check and the readers need."""

    units: int
    seconds: float
    attempted: int
    failed: int
    metrics: Dict[str, float]
    extra: dict = dataclasses.field(default_factory=dict)

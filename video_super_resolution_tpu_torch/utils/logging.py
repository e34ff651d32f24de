"""Structured metrics logging: console lines + ``<name>.jsonl`` (always) +
TensorBoard scalars when ``torch.utils.tensorboard`` is importable, on the
first process only (the ``torch.distributed`` rank 0 when a process group
is initialized), as the JAX package's ``utils/logging.py``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict

import torch


def is_host0() -> bool:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "train",
                 console: bool = True):
        self.is_host0 = is_host0()
        self.console = console and self.is_host0
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if self.is_host0:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(os.path.join(log_dir, "tb"))
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        if not self.is_host0:
            return
        vals = {k: float(v) for k, v in metrics.items()}
        rec = {"step": step, "t": round(time.time() - self._t0, 3), **vals}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in vals.items():
                self._tb.add_scalar(prefix + k, v, step)
        if self.console:
            body = " ".join(f"{k}={v:.5g}" for k, v in vals.items())
            print(f"[{step}] {body}", file=sys.stderr, flush=True)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()

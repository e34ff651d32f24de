"""Temporal-CP scaling: the frame-halo overhead and the weak-scaling
efficiency of the streaming program, the port's counterpart of the JAX
package's ``tools/bench_scaling.py``.

    python -m video_super_resolution_tpu_torch.tools.bench_scaling \\
        [--sizes 1,2,4,8] [--h 64 --w 96 --frames-per-dev 2] [--reps 20] \\
        [--out FILE] [--device cpu]

For each N in ``--sizes``, N processes (``parallel/launch.py:spawn``, one
rank each, this module's ``rank_case``) run ``make_streaming_program`` at
``VSRConfig()`` (seeded random weights) on a time mesh of N with fixed
work a rank (weak scaling: T = frames_per_dev x N frames of h x w, drawn
in turn from numpy's ``default_rng(0)`` as the JAX tool draws them):

- ``compile_s``: the first call's seconds (the slowest rank);
- ``sec``: the best of ``--reps`` calls, each started after a barrier and
  counted as the slowest rank's time;
- ``halo_overhead_eff``: the same per-rank compute on windows assembled
  beforehand (``no_halo_windows``: JAX's ``np.roll`` construction, this
  rank's slice), through the model alone with no exchange, best of
  ``--reps``, over ``sec``. The two programs run in turns (halo, no-halo,
  then no-halo, halo, ...), and ``halo_overhead_eff_quartiles`` are the
  quartiles of the ratio in each turn. At N = 1 nothing is exchanged, so
  that row is the null control: the spread of its ratio around 1.0 is
  what the halo's cost at N >= 2 must stand out of. The JAX tool ran
  each program ``--reps`` (3) times on its own; the port runs 20 pairs
  by default, as 3 left the null control up to 23 % off 1.0 on the card;
- ``weak_scaling_eff`` = t(first N) / t(N); ``launches``: each rank's
  kernel launches in its first streaming call; ``collectives``: rank 0's
  (op, backend, transport, calls) over its streaming calls.

JAX ran the program on N fake CPU devices of one process; the port runs N
processes. On the card rank r takes cuda:r over NCCL when the machine has
a GPU for each rank of the largest N, else every rank of every N shares
cuda:0 over gloo (one transport for all N); ``gpus`` and ``backend`` say
which. ``--device cpu``: gloo ranks of one thread each. Ranks that share
one card contend for it, as JAX's fake devices contend for the host's
cores, so ``halo_overhead_eff`` is the signal and ``weak_scaling_eff`` is
reported for completeness. ``device``: the card's ``nvidia-smi`` name and
power limit, or "cpu". Writes ``artifacts/SCALING_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import MeshConfig, VSRConfig
from video_super_resolution_tpu_torch.parallel import launch
from video_super_resolution_tpu_torch.parallel.streaming import make_streaming_program
from video_super_resolution_tpu_torch.runtime.mesh import build_mesh
from video_super_resolution_tpu_torch.tools import profile_prefix as pp
from video_super_resolution_tpu_torch.tools.bench_dispatch import (
    REPO,
    device_record,
    sync,
    write_record,
)

CASE = "video_super_resolution_tpu_torch.tools.bench_scaling:rank_case"
SEED = 0                # the model's weights, as the JAX tool's PRNGKey(0)
SPAWN_TIMEOUT = 1800.0  # seconds for one N's ranks
NOTE = ("temporal-CP streaming program, one process a rank: N ranks on "
        "{where}. halo_overhead_eff = t(no-halo, same compute)/t(halo) at "
        "each N is the communication-efficiency signal (~1.0 = the frame "
        "halo exchange costs nothing); weak_scaling_eff = t(1)/t(N) at "
        "fixed work a rank is polluted wherever ranks share a device (they "
        "contend for it) and is reported for completeness only.")


def no_halo_windows(frames: np.ndarray, window: int, frames_per_dev: int,
                    n: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s (frames_per_dev, window, h, w, 3) windows of the
    JAX tool's halo-free construction: window i of frame j holds frame
    (j + i) mod T, T = frames_per_dev x n."""
    win = np.stack([np.roll(frames, -i, 0)[: frames_per_dev * n]
                    for i in range(window)], 1)
    return win[rank * frames_per_dev:(rank + 1) * frames_per_dev]


def _turns(fns: Sequence[Callable[[], torch.Tensor]], reps: int,
           dev: torch.device) -> Tuple[torch.Tensor, float, List[List[float]],
                                       Dict[str, int]]:
    """The first call of each fn (the first one's result, seconds and
    kernel launches), then ``reps`` turns of all of them, in turn order
    and reversed every other turn; every call starts after a barrier and
    ends synced. Returns each fn's ``reps`` times too."""
    def call(fn):
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0

    for f in pp.WRAPPERS.values():
        f.launches = 0
    first, first_s = call(fns[0])
    launches = pp.launch_counts()
    for fn in fns[1:]:
        call(fn)
    times = [[] for _ in fns]
    for i in range(reps):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            times[j].append(call(fns[j])[1])
    return first, first_s, times, launches


def rank_case(inputs: dict, device: str) -> dict:
    """A case of ``parallel/launch.py``: this rank's streaming program on
    its frames and the no-halo baseline on its pre-assembled windows."""
    cfg = VSRConfig.from_json(inputs["config"])
    dev = torch.device(device)
    n, rank = dist.get_world_size(), dist.get_rank()
    fpd, (h, w), reps = inputs["frames_per_dev"], inputs["hw"], inputs["reps"]
    frames = inputs["frames"]
    mesh = build_mesh(MeshConfig(time=n), dev)
    model = api.build_model(cfg, dev, SEED)
    program = make_streaming_program(cfg, mesh, (h, w), fpd)
    local = frames[rank * fpd:(rank + 1) * fpd].to(dev)
    win = torch.from_numpy(no_halo_windows(frames.numpy(), cfg.model.window,
                                           fpd, n, rank)).to(dev)

    def no_halo():
        with torch.no_grad():
            return model(win)
    out, compile_s, (sec, nh_sec), launches = _turns(
        [lambda: program(model, local), no_halo], reps, dev)
    return {"out": out.cpu(), "compile_s": compile_s, "sec": sec,
            "no_halo_sec": nh_sec, "launches": launches,
            "collectives": [[*k, v] for k, v in sorted(mesh.transport.items())]}


def transport(device: api.Device, sizes: Sequence[int]
              ) -> Tuple[Optional[str], str, int, str]:
    """(rank device for ``spawn``, backend, GPUs on the machine, where the
    ranks run)."""
    dev = api.resolve_device(device)
    if dev.type == "cpu":
        return "cpu", "gloo", 0, "the host's CPU, one thread each"
    gpus = torch.cuda.device_count()
    if gpus >= max(sizes):
        return None, "nccl", gpus, "one GPU each"   # rank r on cuda:r
    return "cuda:0", "gloo", gpus, "cuda:0, all of them"


def run(sizes: Sequence[int] = (1, 2, 4, 8), h: int = 64, w: int = 96,
        frames_per_dev: int = 2, reps: int = 20, device: api.Device = "cuda",
        cfg: Optional[VSRConfig] = None, out: Optional[str] = None,
        emit: Callable[[str], None] = print):
    """The record of every N (written to ``out`` when given), and each N's
    input frames and streamed output frames in timeline order, as numpy:
    (payload, {N: (frames, out)})."""
    rank_dev, backend, gpus, where = transport(device, sizes)
    cfg = cfg or VSRConfig()
    rng = np.random.default_rng(0)
    results, outputs, t1 = [], {}, None
    for n in sizes:
        t = frames_per_dev * n
        frames = rng.random((t, h, w, 3)).astype(np.float32)
        inputs = {"cases": [CASE], "config": cfg.to_json(),
                  "frames": torch.from_numpy(frames),
                  "frames_per_dev": frames_per_dev, "hw": [h, w],
                  "reps": reps}
        with tempfile.TemporaryDirectory() as io:
            ranks = [r[CASE] for r in launch.spawn(
                inputs, n, io, device=rank_dev, backend=backend,
                timeout=SPAWN_TIMEOUT)]
        halo = [max(r["sec"][i] for r in ranks) for i in range(reps)]
        nh = [max(r["no_halo_sec"][i] for r in ranks) for i in range(reps)]
        best, best_nh = min(halo), min(nh)
        t1 = best if t1 is None else t1
        outputs[n] = (frames, torch.cat([r["out"] for r in ranks]).numpy())
        rec = {"time_axis": n, "frames": t, "sec": best,
               "frames_per_sec": t / best, "weak_scaling_eff": t1 / best,
               "halo_overhead_eff": best_nh / best,
               "halo_overhead_eff_quartiles": np.quantile(
                   np.array(nh) / np.array(halo), (0.25, 0.5, 0.75)).tolist(),
               "compile_s": max(r["compile_s"] for r in ranks),
               "launches": [r["launches"] for r in ranks],
               "collectives": ranks[0]["collectives"]}
        results.append(rec)
        emit(json.dumps(rec))
    payload = {
        "note": NOTE.format(where=where),
        "host_cores": os.cpu_count(),
        "gpus": gpus, "backend": backend,
        "device": device_record(api.resolve_device(device)),
        "shape": [frames_per_dev, h, w],
        "results": results,
    }
    write_record(out, payload)
    emit(json.dumps({"wrote": out, "min_eff": min(
        r["weak_scaling_eff"] for r in results[1:] or results)}))
    return payload, outputs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--w", type=int, default=96)
    ap.add_argument("--frames-per-dev", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sizes", default="1,2,4,8")
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts",
                                                  "SCALING_torch.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run([int(s) for s in args.sizes.split(",")], args.h, args.w,
        args.frames_per_dev, args.reps, args.device, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

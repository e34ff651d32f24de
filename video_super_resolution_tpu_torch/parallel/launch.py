"""Multi-process jobs of the port on one host: each process is one rank of
a ``torch.distributed`` job and runs named cases of the parallel modes.

    python -m video_super_resolution_tpu_torch.parallel.launch --rank R \\
        --world N --port P --io DIR [--device DEV] [--backend BACKEND]

Rank R joins the job at ``localhost:P`` (``runtime.mesh.initialize_
distributed``) on DEV (default ``cuda:{LOCAL_RANK}``, which raises without
a GPU; ``--device cpu`` runs on the CPU), reads ``DIR/inputs.pt`` (written
by the caller with ``torch.save``), runs the cases named in its "cases"
list in order, each on the mesh it builds, and writes their results to
``DIR/result_R.pt``. A case is a function of this module registered with
``@case``, or any importable ``"module:function"`` with the same
signature (inputs, device) -> results. ``spawn`` starts the N processes
and returns their results; a rank that fails, or does not finish within
the timeout, fails the job, and every process it started is stopped.

Inputs: "cases"; "config" (``VSRConfig.to_json()``); "state_dict" (the
model's weights; default: random from "seed"); and what each case reads
(below). Results hold tensors, numbers and strings only.
"""

from __future__ import annotations

import argparse
import importlib
import os
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import MeshConfig, VSRConfig
from video_super_resolution_tpu_torch.data.loader import (
    load_timeline_shard,
    shard_train_batch,
    timeline_shard_indices,
)
from video_super_resolution_tpu_torch.models.common import _Conv3x3
from video_super_resolution_tpu_torch.parallel.temporal import (
    halo_exchange_frames,
    temporal_shard_forward,
)
from video_super_resolution_tpu_torch.parallel.tensor import (
    make_tp_forward,
    make_tp_train_step,
    shard_train_state_tp,
)
from video_super_resolution_tpu_torch.runtime.mesh import (
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_TIME,
    Mesh,
    all_gather,
    all_reduce_sum_,
    build_mesh,
    default_device,
    initialize_distributed,
)
from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
from video_super_resolution_tpu_torch.training.state import create_train_state
from video_super_resolution_tpu_torch.training.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
Case = Callable[[dict, str], dict]
CASES: Dict[str, Case] = {}


def case(fn: Case) -> Case:
    CASES[fn.__name__] = fn
    return fn


def _cfg(inputs: dict) -> VSRConfig:
    return VSRConfig.from_json(inputs["config"])


def _model(inputs: dict, device: str, cfg: Optional[VSRConfig] = None):
    model = api.build_model(cfg or _cfg(inputs), device, inputs.get("seed", 0))
    if "state_dict" in inputs:
        model.load_state_dict(inputs["state_dict"], strict=True)
    return model


def _state(inputs: dict, device: str):
    state = create_train_state(_cfg(inputs), device, inputs.get("seed", 0))
    if "state_dict" in inputs:
        state.model.load_state_dict(inputs["state_dict"], strict=True)
    return state


def local_batch(batch: dict, mesh: Mesh) -> dict:
    """This data rank's slice of a global batch."""
    n, i = mesh.size(AXIS_DATA), mesh.index(AXIS_DATA)
    per = len(batch["lr"]) // n
    local = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
    return shard_train_batch(local, mesh, len(batch["lr"]))


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


@case
def temporal(inputs: dict, device: str) -> dict:
    """time = world: the halo of frames 0..T-1 (one value a frame, r = 1),
    and the rank's frames of the temporal program on "frames"."""
    mesh = build_mesh(MeshConfig(time=torch.distributed.get_world_size()),
                      device)
    frames = inputs["frames"]
    idx = timeline_shard_indices(len(frames), mesh)
    ids = torch.arange(len(frames), dtype=torch.float32).reshape(-1, 1, 1, 1)
    halo = halo_exchange_frames(ids[idx.start:idx.stop].to(device), 1, mesh)
    model = _model(inputs, device)
    run = temporal_shard_forward(lambda w: api.upscale_window(model, w),
                                 mesh, model.cfg.window)
    out = run(frames[idx.start:idx.stop].to(device))
    return {"halo": halo.flatten().cpu(), "frames": out.cpu()}


@case
def stream(inputs: dict, device: str) -> dict:
    """``api.stream_upscale`` of "stream_frames" on the "stream_mesh"."""
    mesh = build_mesh(MeshConfig(**inputs["stream_mesh"]), device)
    out = api.stream_upscale(_model(inputs, device), inputs["stream_frames"],
                             _cfg(inputs), mesh)
    return {"out": torch.from_numpy(out), "transport": str(dict(mesh.transport))}


@case
def train_step(inputs: dict, device: str) -> dict:
    """One train step on "batch" over "step_mesh" (e.g. data, or data x
    space), each data rank on its slice: this rank's metrics."""
    mesh = build_mesh(MeshConfig(**inputs["step_mesh"]), device)
    state = _state(inputs, device)
    _, m = make_train_step(_cfg(inputs).train.charbonnier_eps, mesh)(
        state, local_batch(inputs["batch"], mesh))
    return _metrics(m)


@case
def tp_forward(inputs: dict, device: str) -> dict:
    """model = world: the TP forward of "window" (the model in "tp_config"
    if given, else "config"); whether the unsharded model's parameters and
    prepared-weight caches are as before."""
    mesh = build_mesh(MeshConfig(model=torch.distributed.get_world_size()),
                      device)
    model = _model(inputs, device, VSRConfig.from_json(
        inputs.get("tp_config", inputs["config"])))
    with torch.no_grad():
        model(inputs["window"].to(device))          # fills the caches
    before = {k: v.clone() for k, v in model.state_dict().items()}
    caches = {name: dict(m._prepared) for name, m in model.named_modules()
              if isinstance(m, _Conv3x3)}
    out = make_tp_forward(model, mesh)(inputs["window"])
    after = model.state_dict()
    same_params = all(torch.equal(before[k], after[k]) for k in before)
    same_caches = all(
        m._prepared.keys() == caches[name].keys()
        and all(m._prepared[k] is caches[name][k] for k in caches[name])
        for name, m in model.named_modules() if isinstance(m, _Conv3x3))
    return {"out": out.cpu(), "same_params": same_params,
            "same_caches": same_caches}


@case
def tp_step(inputs: dict, device: str) -> dict:
    """One TP train step on "batch" over "tp_mesh" (data x model): the
    metrics and this rank's shard of ResBlock_0's conv1 kernel after it."""
    mesh = build_mesh(MeshConfig(**inputs["tp_mesh"]), device)
    state = shard_train_state_tp(_state(inputs, device), mesh)
    state, m = make_tp_train_step(mesh, _cfg(inputs).train.charbonnier_eps)(
        state, local_batch(inputs["batch"], mesh))
    w = state.model.sr_head.ResBlock_0.ConvLReLU_0.weight
    return {**_metrics(m), "conv1": w.detach().cpu(),
            "model_index": mesh.index(AXIS_MODEL)}


@case
def feed(inputs: dict, device: str) -> dict:
    """data = world: one step on this rank's own "local_batches"[rank]
    (global batch = their concatenation); then time = world: the sum of
    the clip at "frame_paths", each rank reading only its frames."""
    world = torch.distributed.get_world_size()
    mesh = build_mesh(MeshConfig(data=world), device)
    state = _state(inputs, device)
    local = inputs["local_batches"][mesh.index(AXIS_DATA)]
    batch = shard_train_batch(local, mesh, world * len(local["lr"]))
    _, m = make_train_step(_cfg(inputs).train.charbonnier_eps, mesh)(
        state, batch)
    t_mesh = build_mesh(MeshConfig(time=world), device)
    clip = load_timeline_shard(inputs["frame_paths"], t_mesh)
    tsum = all_reduce_sum_(clip.double().sum().reshape(1), t_mesh, AXIS_TIME)
    shape = [sum(int(c.shape[0]) for c in all_gather(clip, t_mesh, AXIS_TIME)),
             *clip.shape[1:]]
    return {**_metrics(m), "tsum": float(tsum), "clip_shape": shape}


@case
def resume(inputs: dict, device: str) -> dict:
    """data = world: restore the newest checkpoint in "ckpt_dir", then
    steps to "steps" on "step_batches"[s] (each rank its slice), rank 0
    saving after every step; with "die_at", rank 1 exits (code 17) right
    after that step's checkpoint is on disk."""
    mesh = build_mesh(MeshConfig(data=torch.distributed.get_world_size()),
                      device)
    cfg = _cfg(inputs)
    state = _state(inputs, device)
    mgr = CheckpointManager(inputs["ckpt_dir"], keep=3)
    mgr.restore(state)
    start = state.step
    step = make_train_step(cfg.train.charbonnier_eps, mesh)
    losses = {}
    for s in range(start + 1, inputs["steps"] + 1):
        state, m = step(state, local_batch(inputs["step_batches"][s], mesh))
        losses[s] = float(m["loss"])
        if mesh.index(AXIS_DATA) == 0:
            mgr.save(s, state, cfg)
            mgr.wait()
        torch.distributed.barrier()
        if inputs.get("die_at") == s and torch.distributed.get_rank() == 1:
            os._exit(17)
    mgr.close()
    return {"start": start, "final_step": state.step,
            "losses": [[s, v] for s, v in sorted(losses.items())]}


def resolve_case(name: str) -> Case:
    """The case ``name``: registered here, or ``"module:function"``."""
    if ":" not in name:
        return CASES[name]
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(inputs: dict, world: int, io_dir: str, device: Optional[str] = None,
          backend: Optional[str] = None, timeout: float = 120.0,
          crash: Optional[tuple] = None, env: Optional[dict] = None
          ) -> List[Optional[dict]]:
    """Run ``inputs["cases"]`` in ``world`` processes, one rank each, and
    return every rank's results. Rank r runs on ``device`` (default
    ``cuda:r``: ``LOCAL_RANK`` is r) with ``backend`` (default: as
    ``initialize_distributed``). All processes must exit 0 within
    ``timeout`` seconds, else they are all stopped and RuntimeError raises
    with the failing rank's output; with ``crash`` = (rank, code), that
    rank must exit with that code instead, the others are stopped when it
    has, and the results are None."""
    os.makedirs(io_dir, exist_ok=True)
    torch.save(inputs, os.path.join(io_dir, "inputs.pt"))
    port = free_port()
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("VSR_COORD_BARRIER_TIMEOUT_S", str(int(timeout)))
    cmd = [sys.executable, "-m", "video_super_resolution_tpu_torch.parallel.launch",
           "--world", str(world), "--port", str(port), "--io", io_dir]
    cmd += (["--device", device] if device else []) + (
        ["--backend", backend] if backend else [])
    logs = [os.path.join(io_dir, f"log_{r}.txt") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                cmd + ["--rank", str(r)], env={**env, "LOCAL_RANK": str(r)},
                stdout=out, stderr=subprocess.STDOUT))
    want = [0] * world
    order = list(range(world))
    if crash is not None:
        want[crash[0]] = crash[1]
        order.remove(crash[0])
        order.insert(0, crash[0])
    deadline = time.monotonic() + timeout
    try:
        while True:     # the first rank to exit with the wrong code fails it
            rcs = [p.poll() for p in procs]
            for r in order:
                if rcs[r] is not None and rcs[r] != want[r]:
                    with open(logs[r]) as f:
                        raise RuntimeError(f"rank {r} of {world} exited "
                                           f"{rcs[r]}, not {want[r]}:\n"
                                           f"{f.read()[-4000:]}")
                if crash is not None and r == crash[0] and rcs[r] is not None:
                    return [None] * world
            if None not in rcs:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"rank {rcs.index(None)} of {world} did "
                                   f"not finish in {timeout:.0f} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(os.path.join(io_dir, f"result_{r}.pt"),
                       weights_only=True) for r in range(world)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--io", required=True)
    ap.add_argument("--device", help="default: cuda:{LOCAL_RANK}")
    ap.add_argument("--backend")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    if device.type == "cpu":
        # one thread: the ranks share the host's cores, and a CPU op split
        # over threads may sum in an order that depends on their timing,
        # which the kill-and-resume test would see (it wants equal bits)
        torch.set_num_threads(1)
    initialize_distributed(f"localhost:{args.port}", args.world, args.rank,
                           device, args.backend)
    try:
        inputs = torch.load(os.path.join(args.io, "inputs.pt"),
                            weights_only=True)
        results = {name: resolve_case(name)(inputs, str(device))
                   for name in inputs["cases"]}
        torch.save(results, os.path.join(args.io, f"result_{args.rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

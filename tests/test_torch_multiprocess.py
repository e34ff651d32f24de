"""The port's multi-process runtime on the CPU with gloo, as
``tests/test_multiprocess.py`` and ``tests/test_multiprocess_resume.py``
hold the JAX package's: a real 2-process job (``parallel/launch.py``),
each rank feeding its own data.

- psum and timeline: a dp train step on each rank's own batch gives every
  rank the global loss and grad_norm, equal to JAX's step on the
  concatenated batch; each rank reads only its block of a PNG clip, and
  the sum over the time axis is the clip's;
- kill and resume: rank 1 dies right after the step-2 checkpoint; a
  relaunch restores step 2 and reproduces the uninterrupted run's losses
  bit for bit;
- ``cli train`` with ``--set mesh.data=2`` under torchrun's environment
  variables, for 2 steps.

The batches and the config are the JAX tools' (``tools/multiprocess_*.py``),
with f32 compute where JAX is the reference.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.parallel import launch
from video_super_resolution_tpu_torch.weights import from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from multiprocess_smoke import local_batch, small_cfg  # noqa: E402
from multiprocess_train_worker import global_batch_for_step  # noqa: E402
import torch_workers  # noqa: E402, F401  caps torch's threads per xdist worker


def _port_cfg(jcfg) -> VSRConfig:
    return VSRConfig.from_dict(dataclasses.asdict(jcfg))


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _write_frames(tmp_path, t=8, h=16, w=24):
    from PIL import Image

    rng = np.random.default_rng(7)
    frames = (rng.random((t, h, w, 3)) * 255).astype(np.uint8)
    paths = []
    for i in range(t):
        paths.append(str(tmp_path / f"{i:03d}.png"))
        Image.fromarray(frames[i]).save(paths[-1])
    return paths, frames.astype(np.float32) / 255.0


def test_two_process_psum_and_timeline(tmp_path):
    from video_super_resolution_tpu.config import MeshConfig
    from video_super_resolution_tpu.runtime.mesh import build_mesh
    from video_super_resolution_tpu.training.state import create_train_state
    from video_super_resolution_tpu.training.step import make_train_step

    jcfg = small_cfg()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train,
                                                  compute_dtype="float32"))
    state = create_train_state(jcfg)
    paths, frames = _write_frames(tmp_path)
    inputs = {"cases": ["feed"], "config": _port_cfg(jcfg).to_json(),
              "state_dict": from_jax_params(jax.tree.map(np.asarray,
                                                         state.params),
                                            _port_cfg(jcfg)),
              "local_batches": [_tensors(local_batch(p)) for p in (0, 1)],
              "frame_paths": paths}
    a, b = (r["feed"] for r in launch.spawn(inputs, 2, str(tmp_path / "io"),
                                            device="cpu"))
    assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert a["clip_shape"] == [8, 16, 24, 3]
    np.testing.assert_allclose(a["tsum"], frames.sum(), rtol=1e-5)
    assert a["tsum"] == b["tsum"]

    mesh = build_mesh(MeshConfig(data=8))
    state = jax.device_put(state, NamedSharding(mesh, P()))
    b0, b1 = local_batch(0), local_batch(1)
    batch = {k: np.concatenate([b0[k], b1[k]]) for k in b0}
    _, m = make_train_step(jcfg.train.charbonnier_eps, mesh=mesh,
                           donate=False)(state, batch)
    np.testing.assert_allclose(a["loss"], float(m["loss"]), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(a["grad_norm"], float(m["grad_norm"]),
                               rtol=2e-3)


def test_multiprocess_kill_resume(tmp_path):
    steps, die_at = 4, 2
    cfg = _port_cfg(small_cfg())
    base = {"cases": ["resume"], "config": cfg.to_json(), "steps": steps,
            "step_batches": {s: _tensors(global_batch_for_step(s, 2))
                             for s in range(1, steps + 1)}}

    def run(name, **kw):
        inputs = {**base, "ckpt_dir": str(tmp_path / name)}
        crash = None
        if "die_at" in kw:
            inputs["die_at"] = kw["die_at"]
            crash = (1, 17)
        return launch.spawn(inputs, 2, str(tmp_path / f"io_{name}_{len(kw)}"),
                            device="cpu", crash=crash)

    ref = [r["resume"] for r in run("ref")]
    assert ref[0]["losses"] == ref[1]["losses"]
    assert ref[0]["final_step"] == steps
    assert [s for s, _ in ref[0]["losses"]] == list(range(1, steps + 1))

    assert run("crash", die_at=die_at) == [None, None]
    assert os.path.exists(tmp_path / "crash" / f"ckpt_{die_at}.pt")
    res = [r["resume"] for r in run("crash")]
    for r in res:
        assert r["start"] == die_at and r["final_step"] == steps
    assert res[0]["losses"] == ref[0]["losses"][die_at:]


def test_launch_rank_defaults_to_the_card(tmp_path, monkeypatch):
    """A rank started without ``--device`` runs on ``cuda:{LOCAL_RANK}``:
    without a GPU it raises before it joins the job."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.main(["--rank", "0", "--world", "2", "--port",
                     str(launch.free_port()), "--io", str(tmp_path)])
    assert not torch.distributed.is_initialized()


def test_cli_train_two_ranks(tmp_path):
    """``cli train --set mesh.data=2`` as torchrun starts it: both ranks
    join the gloo group from RANK/WORLD_SIZE/MASTER_*; rank 0 writes the
    checkpoint and the log of the 2 steps."""
    from PIL import Image

    from video_super_resolution_tpu_torch.data.synthetic import moving_gradient_clip
    from test_torch_cli import TINY_SET

    clips = tmp_path / "clips" / "clip_a"
    clips.mkdir(parents=True)
    frames, _ = moving_gradient_clip(num_frames=3, h=64, w=64, seed=3)
    for i, f in enumerate(frames):
        Image.fromarray((f * 255).astype(np.uint8)).save(clips / f"{i:04d}.png")
    ckpt = tmp_path / "ckpt"
    port = launch.free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "WORLD_SIZE": "2",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "VSR_COORD_BARRIER_TIMEOUT_S": "120"}
    cmd = [sys.executable, "-m", "video_super_resolution_tpu_torch.cli",
           "train", "--hr-root", str(tmp_path / "clips"), "--ckpt-dir",
           str(ckpt), "--steps", "2", "--device", "cpu", "--set", *TINY_SET,
           "mesh.data=2"]
    procs = [subprocess.Popen(cmd, env={**env, "RANK": str(r),
                                        "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert os.listdir(ckpt) and "ckpt_2.pt" in os.listdir(ckpt)
    logs = [json.loads(r) for r in open(ckpt / "train.jsonl")]
    assert logs[-1]["step"] == 2 and np.isfinite(logs[-1]["loss"])

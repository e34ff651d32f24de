"""The port's CLI (``video_super_resolution_tpu_torch.cli``) on the CPU:
train a few steps on PNG clips, eval the checkpoint, infer PNG frames,
inspect a torch checkpoint; the JAX CLI's dotted overrides; and the GPU
default, which raises without a card."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from video_super_resolution_tpu import cli as jcli

from video_super_resolution_tpu_torch import cli
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.data.synthetic import moving_gradient_clip
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SET = [
    "model.pyramid_channels=8,16", "model.flow_estimator_channels=16,16",
    "model.context_channels=16,16", "model.depth_channels=8",
    "model.depth_levels=2", "model.fusion_channels=16", "model.sr_channels=16",
    "model.sr_blocks=2", "model.sr_head_style=two_stage",
    "model.warp_features=true", "data.crop_size=16", "data.batch_size=2",
    "train.warmup_steps=0", "train.ckpt_every=2", "train.log_every=2",
    "train.compute_dtype=float32",
]


@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("clips")
    for name in ("clip_a", "clip_b"):
        d = root / name
        d.mkdir()
        frames, _ = moving_gradient_clip(num_frames=3, h=64, w=64,
                                         seed=len(name) + ord(name[-1]))
        for i, f in enumerate(frames):
            Image.fromarray((f * 255).astype(np.uint8)).save(d / f"{i:04d}.png")
    return str(root)


def run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def test_cli_train_eval_infer_on_cpu(clip_root, tmp_path):
    from PIL import Image

    ckpt = str(tmp_path / "ckpt")
    run(["train", "--hr-root", clip_root, "--ckpt-dir", ckpt, "--steps", "4",
         "--device", "cpu", "--set", *TINY_SET])
    assert {"ckpt_2.pt", "ckpt_4.pt"} <= set(os.listdir(ckpt))
    logs = [json.loads(r) for r in open(os.path.join(ckpt, "train.jsonl"))]
    assert "native_loader" in logs[0] and logs[-1]["step"] == 4

    res = json.loads(run(["eval", "--hr-root", clip_root, "--ckpt-dir", ckpt,
                          "--device", "cpu"]))
    assert res["step"] == 4 and set(res) == {"step", "clip_a", "clip_b",
                                             "__average__"}
    assert np.isfinite(res["__average__"]["psnr"])
    assert res["__average__"]["frames"] == 6

    out = str(tmp_path / "out")
    run(["infer", "--lr-root", clip_root, "--out-dir", out, "--ckpt-dir",
         ckpt, "--device", "cpu"])
    for clip in ("clip_a", "clip_b"):
        files = sorted(os.listdir(os.path.join(out, clip)))
        assert files == [f"{i:08d}.png" for i in range(3)]
        assert Image.open(os.path.join(out, clip, files[0])).size == (256, 256)


def test_cli_import_weights(tmp_path):
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": {"net.conv1.weight": torch.zeros(8, 3, 3, 3),
                               "net.conv1.bias": torch.zeros(8)}}, path)
    assert json.loads(run(["import-weights", "--torch-ckpt", path])) == {
        "net.conv1.weight": [8, 3, 3, 3], "net.conv1.bias": [8]}
    proc = subprocess.run(
        [sys.executable, "-m", "video_super_resolution_tpu_torch.cli",
         "import-weights", "--torch-ckpt", path],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["net.conv1.bias"] == [8]


def test_cli_overrides_match_jax():
    sets = TINY_SET + ["mesh.data=2", "train.lr=2e-4", "data.augment=no"]
    got = cli._apply_overrides(VSRConfig(), sets)
    want = jcli._apply_overrides(jcli.VSRConfig(), sets)
    assert got.to_json() == want.to_json()
    assert got.model.sr_head_style == "two_stage" and got.model.warp_features
    for bad in (["model.nope=1"], ["nope.x=1"], ["model.window"]):
        with pytest.raises(SystemExit):
            cli._apply_overrides(VSRConfig(), bad)


def test_cli_defaults_to_cuda(clip_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(["train", "--hr-root", clip_root, "--ckpt-dir",
             str(tmp_path / "c"), "--steps", "1", "--set", *TINY_SET])

"""The port's binding of the native C++ data path (``data/native_loader.py``)
against the JAX package's binding of the same source (``native/
vsr_dataio.cc``): PNG decode, the MATLAB bicubic, and, with one worker, the
same batches for the same seed; its build rule; and the train loop on it
(compact batches, ``native_loader`` logged).

Both bindings need g++ and libpng's header; the JAX one also needs
``native/libvsr_dataio.so``, which the test harness builds with ``make``.
"""

import json

import numpy as np
import pytest
import torch

from video_super_resolution_tpu.data import native_loader as jnative
from video_super_resolution_tpu.data.degrade import degrade_bicubic

from video_super_resolution_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
    VSRConfig,
)
from video_super_resolution_tpu_torch.data import native_loader as pnative
from video_super_resolution_tpu_torch.data.dataset import ClipDataset, list_clips
from video_super_resolution_tpu_torch.data.synthetic import moving_gradient_clip
from video_super_resolution_tpu_torch.training import loop
from video_super_resolution_tpu_torch.training.step import decode_batch


@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    from PIL import Image

    if not pnative.available():
        pytest.skip(f"native loader cannot be built here: missing "
                    f"{pnative.missing()}")
    root = tmp_path_factory.mktemp("native_clips")
    for name in ("a", "b"):
        d = root / name
        d.mkdir()
        frames, _ = moving_gradient_clip(num_frames=5, h=96, w=96,
                                         seed=ord(name))
        for i, f in enumerate(frames):
            Image.fromarray((f * 255).astype(np.uint8)).save(d / f"{i:04d}.png")
    return root


@pytest.fixture(scope="module")
def jax_binding():
    if not jnative.available():
        pytest.skip("native/libvsr_dataio.so not built (make -C native)")
    return jnative


def test_decode_and_bicubic_match_jax_binding(clip_root, jax_binding, rng):
    from PIL import Image

    p = str(clip_root / "a" / "0002.png")
    got = pnative.decode_png(p)
    np.testing.assert_array_equal(got, jax_binding.decode_png(p))
    np.testing.assert_allclose(
        got, np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0,
        atol=1e-6)
    img = rng.random((64, 80, 3)).astype(np.float32)
    out = pnative.resize_bicubic_aa(img, 16, 20)
    np.testing.assert_array_equal(out, jax_binding.resize_bicubic_aa(img, 16, 20))
    np.testing.assert_allclose(out, degrade_bicubic(img[None], 4)[0],
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(IOError):
        pnative.decode_png(str(clip_root / "missing.png"))


@pytest.mark.parametrize("augment", [True, False])
def test_same_seed_same_batches_as_jax_binding(clip_root, jax_binding, augment):
    clips = list_clips(str(clip_root))
    kw = dict(window=3, scale=4, crop_size=16, batch_size=2, augment=augment,
              num_workers=1, seed=7)
    mine = pnative.NativeClipLoader(clips, **kw)
    try:
        ours = [next(mine) for _ in range(3)]
    finally:
        mine.close()
    theirs_ld = jax_binding.NativeClipLoader(clips, **kw)
    try:
        theirs = [next(theirs_ld) for _ in range(3)]
    finally:
        theirs_ld.close()
    for a, b in zip(ours, theirs):
        assert a["lr"].shape == (2, 3, 16, 16, 3) and a["hr"].shape == (2, 64, 64, 3)
        np.testing.assert_array_equal(a["lr"], b["lr"])
        np.testing.assert_array_equal(a["hr"], b["hr"])
    assert mine._handle is None
    with pytest.raises(StopIteration):
        next(mine)


def test_missing_tools_are_named(monkeypatch):
    pnative.missing.cache_clear()
    try:
        monkeypatch.setattr(pnative.shutil, "which", lambda name: None)
        assert pnative.missing() == ("g++",)
        assert not pnative.available()
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            pnative.build()
    finally:
        pnative.missing.cache_clear()


def test_compile_error_raises_with_gxx_output(clip_root, tmp_path, monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(pnative, "SOURCE", bad)
    monkeypatch.setattr(pnative, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cc"):
        pnative.build()


def tiny_cfg(run_dir, compute_dtype):
    return VSRConfig(
        model=ModelConfig(pyramid_channels=(8, 16),
                          flow_estimator_channels=(16, 16),
                          context_channels=(16, 16), depth_channels=8,
                          depth_levels=2, fusion_channels=16, sr_channels=16,
                          sr_blocks=2),
        train=TrainConfig(warmup_steps=0, log_every=2, ckpt_every=100,
                          ckpt_dir=str(run_dir), compute_dtype=compute_dtype),
        data=DataConfig(batch_size=2, crop_size=16))


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_loop_trains_on_the_native_loader(clip_root, tmp_path, compute_dtype,
                                          monkeypatch):
    """A path-backed HR-only dataset goes through the native loader; with
    bf16 compute its batches travel compact (uint8 HR, bf16 LR), exactly
    for the HR; ``native_loader`` 1 is logged at the start step, and the
    loader is closed at the end."""
    seen, closed = [], []
    real_compact = loop.compact_batches
    real_close = pnative.NativeClipLoader.close

    def spy_compact(batches):
        for b in real_compact(batches):
            seen.append(b)
            yield b

    def spy_close(self):
        closed.append(self._handle is not None)
        real_close(self)

    monkeypatch.setattr(loop, "compact_batches", spy_compact)
    monkeypatch.setattr(pnative.NativeClipLoader, "close", spy_close)
    cfg = tiny_cfg(tmp_path / "run", compute_dtype)
    ds = ClipDataset(hr_root=str(clip_root), crop_size=16, seed=0)
    out = loop.train(cfg, ds, max_steps=2, device="cpu")
    assert out["state"].step == 2
    logs = [json.loads(r) for r in (tmp_path / "run" / "train.jsonl")
            .read_text().splitlines()]
    assert logs[0] == {"step": 0, "t": logs[0]["t"], "native_loader": 1.0}
    assert closed and closed[0]
    if compute_dtype == "bfloat16":
        assert len(seen) >= 2
        b = seen[0]
        assert b["hr"].dtype == torch.uint8 and b["lr"].dtype == torch.bfloat16
        _, hr = decode_batch(b, torch.device("cpu"))
        u8 = b["hr"].numpy()
        np.testing.assert_array_equal(hr.numpy(), u8.astype(np.float32) / 255.0)
    else:
        assert not seen


def test_compact_batches_are_exact_for_8_bit_sources():
    u8 = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    lr = np.random.default_rng(1).random((2, 3, 16, 16, 3)).astype(np.float32)
    (b,) = loop.compact_batches(iter([{"lr": lr, "hr": u8 / np.float32(255.0)}]))
    assert torch.equal(b["hr"], torch.from_numpy(u8))
    assert torch.equal(b["lr"], torch.from_numpy(lr).to(torch.bfloat16))


def test_in_memory_dataset_logs_python_loader(tmp_path):
    clips = {"c": moving_gradient_clip(4, 64, 64, 1.0, -0.5, seed=0)[0]}
    cfg = tiny_cfg(tmp_path / "run", "float32")
    loop.train(cfg, ClipDataset(clips_hr=clips, crop_size=16), max_steps=2,
               device="cpu")
    first = json.loads((tmp_path / "run" / "train.jsonl").read_text()
                       .splitlines()[0])
    assert first["native_loader"] == 0.0

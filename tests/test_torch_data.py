"""The port's data pipeline against the JAX package's, on the CPU: bicubic
resize and the MATLAB-preset degradation, the synthetic clip families,
and ``ClipDataset`` sampling under one seed (same crops, flips, temporal
reversals and windows). The clip generators and the dataset are numpy in
both packages and agree exactly; the resize computes the same f32 taps in
another framework and agrees to atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.data import dataset as jds
from video_super_resolution_tpu.data import synthetic as jsyn
from video_super_resolution_tpu.data.degrade import degrade_bicubic as jax_degrade
from video_super_resolution_tpu.ops.resize import resize_bicubic as jax_bicubic

from video_super_resolution_tpu_torch.data import dataset as pds
from video_super_resolution_tpu_torch.data import synthetic as psyn
from video_super_resolution_tpu_torch.data.degrade import degrade_bicubic
from video_super_resolution_tpu_torch.ops.resize import resize_bicubic
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

RESIZE_TOL = dict(rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 3, 32, 48, 3), (2, 32, 48, 3),
                                   (32, 48, 3), (32, 48)])
@pytest.mark.parametrize("out_hw", [(8, 12), (64, 96), (32, 20), (32, 48)])
def test_resize_bicubic_matches_jax(shape, out_hw):
    """The MATLAB preset (a=-0.5, antialias, replicate edges) that degrade
    uses: down, up, mixed and same-size, on every input rank."""
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(jax_bicubic(jnp.asarray(x), *out_hw, a=-0.5,
                                  antialias=True, edge="replicate"))
    got = resize_bicubic(torch.from_numpy(x), *out_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **RESIZE_TOL)


@pytest.mark.parametrize("shape,scale", [((2, 64, 48, 3), 4), ((40, 24, 3), 2)])
def test_degrade_bicubic_matches_jax(shape, scale):
    hr = np.random.default_rng(1).random(shape).astype(np.float32)
    got = degrade_bicubic(hr, scale)
    want = np.asarray(jax_degrade(hr, scale))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, **RESIZE_TOL)
    with pytest.raises(ValueError, match="divisible"):
        degrade_bicubic(hr[..., :-1, :, :], scale)


@pytest.mark.parametrize("name,kw", [
    ("moving_gradient_clip", dict(num_frames=4, h=24, w=32, seed=3)),
    ("zooming_clip", dict(num_frames=3, h=24, w=24, seed=1)),
    ("zooming_clip", dict(num_frames=3, h=24, w=24, seed=1, rough=0.8)),
    ("detail_clip", dict(num_frames=3, h=32, w=24, seed=2)),
    ("layered_clip", dict(num_frames=3, h=32, w=32, seed=4)),
    ("shear_clip", dict(num_frames=3, h=24, w=32, seed=5))])
def test_synthetic_clips_equal_jax(name, kw):
    want = getattr(jsyn, name)(**kw)
    got = getattr(psyn, name)(**kw)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(a, b)


def test_noise_and_clip_pair_match_jax():
    frames = psyn.detail_clip(3, 16, 16, seed=1)
    np.testing.assert_array_equal(psyn.add_noise(frames, 0.05, seed=2),
                                  jsyn.add_noise(frames, 0.05, seed=2))
    lr, hr = psyn.synthetic_clip_pair(3, 32, 48, 4, seed=6)
    jlr, jhr = jsyn.synthetic_clip_pair(3, 32, 48, 4, seed=6)
    np.testing.assert_array_equal(hr, jhr)
    np.testing.assert_allclose(lr, jlr, **RESIZE_TOL)


@pytest.mark.parametrize("mode", ["replicate", "reflect"])
def test_sliding_window_indices_equal_jax(mode):
    for nf in ((1, 2, 7) if mode == "replicate" else (2, 7)):
        for window in (3, 5):
            for center in range(nf):
                assert (pds.sliding_window_indices(nf, center, window, mode)
                        == jds.sliding_window_indices(nf, center, window, mode))
    assert pds.sliding_window_indices(1, 0, 5, mode) == [0] * 5
    with pytest.raises(ValueError):
        pds.sliding_window_indices(5, 0, 3, "wrap")


def _clips():
    return {f"clip{i}": psyn.moving_gradient_clip(5, 32, 48, 1.0 + i, -0.5,
                                                  seed=i)[0]
            for i in range(3)}


def _same_samples(a, b, n=6):
    for _ in range(n):
        sa, sb = a.sample(), b.sample()
        np.testing.assert_array_equal(sa["hr"], sb["hr"])
        np.testing.assert_allclose(sa["lr"], sb["lr"], **RESIZE_TOL)


@pytest.mark.parametrize("augment", [True, False])
def test_clip_dataset_in_memory_samples_equal_jax(augment):
    clips = _clips()
    kw = dict(window=3, scale=4, crop_size=6, augment=augment, seed=11)
    port = pds.ClipDataset(clips_hr=clips, **kw)
    ref = jds.ClipDataset(clips_hr=clips, **kw)
    assert port.clip_names == ref.clip_names
    _same_samples(port, ref)
    bp, bj = next(port.batches(3)), next(ref.batches(3))
    assert bp["lr"].shape == (3, 3, 6, 6, 3) and bp["hr"].shape == (3, 24, 24, 3)
    np.testing.assert_array_equal(bp["hr"], bj["hr"])
    np.testing.assert_allclose(bp["lr"], bj["lr"], **RESIZE_TOL)
    for wp, wj in zip(port.eval_windows("clip1"), ref.eval_windows("clip1")):
        assert wp["center"] == wj["center"]
        np.testing.assert_array_equal(wp["hr"], wj["hr"])
        np.testing.assert_allclose(wp["lr"], wj["lr"], **RESIZE_TOL)


def test_clip_dataset_from_files_equals_jax(tmp_path):
    """Path-backed HR-only clips (.npy frames): LR degraded per frame."""
    for name, frames in _clips().items():
        (tmp_path / name).mkdir()
        for t, f in enumerate(frames):
            np.save(tmp_path / name / f"{t:03d}.npy", f)
    assert pds.list_clips(str(tmp_path)) == jds.list_clips(str(tmp_path))
    kw = dict(window=3, scale=4, crop_size=8, augment=True, seed=5,
              edge_mode="reflect")
    port = pds.ClipDataset(hr_root=str(tmp_path), **kw)
    ref = jds.ClipDataset(hr_root=str(tmp_path), **kw)
    _same_samples(port, ref, n=4)
    with pytest.raises(ValueError, match="smaller than crop"):
        pds.ClipDataset(hr_root=str(tmp_path), crop_size=64).sample()

"""The port's evaluation against the JAX package's, on the CPU: BT.601 luma,
PSNR and SSIM (numpy in both packages: equal), and ``evaluate_clip`` /
``evaluate_all`` of the same tiny f32 model (weights drawn in the port and
carried to flax by path) on a synthetic dataset, through the port's
``api.eval_step`` and the JAX package's ``make_eval_step``. The models
agree to the composed-model tolerance, which moves PSNR by well under
0.01 dB and SSIM by under 1e-4 here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.config import ModelConfig as JModelConfig
from video_super_resolution_tpu.data.dataset import ClipDataset as JClipDataset
from video_super_resolution_tpu.evaluation import evaluate as jeval
from video_super_resolution_tpu.evaluation import metrics as jmetrics
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel
from video_super_resolution_tpu.training.step import make_eval_step as jax_eval_step

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import ModelConfig
from video_super_resolution_tpu_torch.data.dataset import ClipDataset
from video_super_resolution_tpu_torch.data.synthetic import synthetic_clip_pair
from video_super_resolution_tpu_torch.evaluation import metrics
from video_super_resolution_tpu_torch.evaluation.evaluate import evaluate_all, evaluate_clip
from video_super_resolution_tpu_torch.models.common import init_params
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.training.step import make_eval_step
from video_super_resolution_tpu_torch.weights import to_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

TINY = dict(pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
            context_channels=(16, 16), depth_channels=8, depth_levels=2,
            fusion_channels=16, sr_channels=16, sr_blocks=2,
            warp_impl="gather")


def images(seed, shape=(2, 40, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape)
    b = np.clip(a + rng.normal(0, 0.05, shape), 0, 1)
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("y_channel,crop", [(True, 4), (False, 0), (True, 0)])
def test_psnr_ssim_equal_jax(y_channel, crop):
    a, b = images(0)
    assert metrics.psnr(a, b, y_channel, crop) == jmetrics.psnr(a, b, y_channel, crop)
    assert metrics.ssim(a, b, y_channel, crop) == jmetrics.ssim(a, b, y_channel, crop)
    assert metrics.ssim(a[0], b[0], y_channel, crop) == jmetrics.ssim(
        a[0], b[0], y_channel, crop)
    np.testing.assert_array_equal(metrics.rgb_to_y(a), jmetrics.rgb_to_y(a))
    assert metrics.psnr(a, a) == float("inf")


@pytest.fixture(scope="module")
def models_and_data():
    port = init_params(VSRModel(ModelConfig(**TINY)),
                       torch.Generator().manual_seed(0)).eval()
    jm = JVSRModel(cfg=JModelConfig(**TINY), dtype=jnp.float32)
    params = to_jax_params(port.state_dict())
    clips = {f"c{i}": synthetic_clip_pair(5, 64, 64, 4, seed=i)[1]
             for i in range(2)}
    return (port, ClipDataset(clips_hr=clips, crop_size=16),
            jax_eval_step(jm.apply), params, JClipDataset(clips_hr=clips,
                                                          crop_size=16))


def test_evaluate_all_matches_jax(models_and_data):
    port, ds, jstep, params, jds = models_and_data
    got = evaluate_all(api.eval_step, port, ds, batch_windows=2)
    want = jeval.evaluate_all(jstep, params, jds, batch_windows=2)
    assert got.keys() == want.keys() == {"c0", "c1", "__average__"}
    for k in got:
        assert got[k]["frames"] == want[k]["frames"]
        np.testing.assert_allclose(got[k]["psnr"], want[k]["psnr"], atol=0.01)
        np.testing.assert_allclose(got[k]["ssim"], want[k]["ssim"], atol=1e-4)


def test_evaluate_clip_pads_the_last_group(models_and_data):
    """5 windows in groups of 3: the last group is padded, the padded
    outputs dropped; the result does not depend on the group size."""
    port, ds, *_ = models_and_data
    step = make_eval_step()
    a = evaluate_clip(step, port, ds, "c0", batch_windows=3)
    b = evaluate_clip(step, port, ds, "c0", batch_windows=1)
    assert a["frames"] == b["frames"] == 5
    np.testing.assert_allclose(a["psnr"], b["psnr"], rtol=1e-6)
    np.testing.assert_allclose(a["ssim"], b["ssim"], rtol=1e-6)

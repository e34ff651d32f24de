"""The PyTorch port's composed VSRModel against the JAX package, on the CPU
in f32: at the frozen golden config (JAX init key 42) against the JAX
model and against tests/golden/e2e.npz (read only), and at the serving
config's full widths on a small window. Composed-model tolerance: rtol
2e-3, atol 5e-4 (the existing torch oracle's).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.config import serving_config as jax_serving_config
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import ModelConfig, serving_config
from video_super_resolution_tpu_torch.models.common import init_params
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.weights import from_jax_params, to_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "e2e.npz")
MODEL_TOL = dict(rtol=2e-3, atol=5e-4)


def golden_cfg():
    """tests/test_golden_regression.py's frozen config."""
    return dict(
        window=3, pyramid_levels=3, pyramid_channels=(8, 16, 32),
        max_displacement=2, flow_finest_level=1,
        flow_estimator_channels=(16, 12), context_channels=(16, 12),
        depth_channels=8, depth_levels=2, fusion_channels=16,
        sr_channels=16, sr_blocks=3, sr_wide_blocks=False,
        warp_impl="gather", depth_res_divisor=4,
    )


def golden_window():
    t = np.arange(3, dtype=np.float32)[:, None, None, None]
    y = np.arange(24, dtype=np.float32)[None, :, None, None]
    x = np.arange(32, dtype=np.float32)[None, None, :, None]
    c = np.arange(3, dtype=np.float32)[None, None, None, :]
    return (0.5 + 0.4 * np.sin(0.3 * (x + 2 * t) + 0.7 * c)
            * np.cos(0.2 * (y - t)))[None].astype(np.float32)


@pytest.fixture(scope="module")
def golden_pair():
    from video_super_resolution_tpu.config import ModelConfig as JModelConfig

    jm = JVSRModel(cfg=JModelConfig(**golden_cfg()), dtype=jnp.float32)
    window = golden_window()
    params = jm.init(jax.random.key(42), jnp.asarray(window))["params"]
    aux = jm.apply({"params": params}, jnp.asarray(window), return_aux=True)
    port = VSRModel(ModelConfig(**golden_cfg()))
    port.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), port.cfg),
        strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(window), return_aux=True)
    return {k: np.asarray(v) for k, v in aux.items()}, \
        {k: v.numpy() for k, v in got.items()}


def test_vsr_matches_golden_fixture(golden_pair):
    _, got = golden_pair
    out = got["hr"]
    ref = np.load(GOLDEN)
    assert out.shape == tuple(ref["shape"])
    np.testing.assert_allclose(out.mean(), float(ref["mean"]), rtol=1e-4)
    np.testing.assert_allclose(np.abs(out).max(), float(ref["absmax"]),
                               rtol=1e-4)
    np.testing.assert_allclose(out[0, ::64, ::64, :], ref["subsample"],
                               **MODEL_TOL)


@pytest.mark.parametrize("key,tol", [
    ("hr", MODEL_TOL),
    ("flows", dict(rtol=2e-3, atol=2e-4)),
    ("depth", dict(rtol=1e-4, atol=1e-5)),
])
def test_vsr_matches_jax_at_golden_config(golden_pair, key, tol):
    want, got = golden_pair
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], **tol)


def test_vsr_serving_widths_match_jax():
    """serving_config() at full width (5-level pyramid, d=4, 13-conv depth
    hourglass at 1/4 res, 5 wide SR blocks) on a (1, 3, 64, 64, 3) window.
    Weights are drawn in the port and carried to flax by path."""
    jcfg = jax_serving_config(warp_impl="gather").model
    pcfg = ModelConfig(**dataclasses.asdict(jcfg))
    port = init_params(VSRModel(pcfg), torch.Generator().manual_seed(0))
    params = to_jax_params(port.state_dict())
    x = np.random.default_rng(0).random((1, 3, 64, 64, 3)).astype(np.float32)
    jm = JVSRModel(cfg=jcfg, dtype=jnp.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 256, 256, 3)
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_eval_step_clips_and_matches_forward():
    cfg = serving_config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, **{
            k: v for k, v in golden_cfg().items() if k != "warp_impl"}),
        train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    model = api.build_model(cfg, device="cpu", seed=3)
    window = torch.from_numpy(golden_window())
    hr = api.upscale_window(model, window)
    out = api.eval_step(model, window)
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, 96, 128, 3)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    assert torch.equal(out, hr.clamp(0.0, 1.0))


def test_serving_model_runs_in_bf16_on_cpu():
    """The default policy's compute dtype (bf16) at serving widths: finite
    f32 output of the expected shape."""
    model = api.build_model(serving_config(), device="cpu", seed=0)
    assert model.dtype == torch.bfloat16
    out = api.eval_step(model, torch.rand((1, 3, 20, 36, 3),
                                          generator=torch.Generator().manual_seed(0)))
    assert tuple(out.shape) == (1, 80, 144, 3)
    assert bool(torch.isfinite(out).all())

"""The reference-era model options of the port against the JAX package on
the CPU in f32: the two_stage SR head (its upsample stages are the fused
conv with ``shuffle=True``), ``sr_espcn_mid`` and ``warp_features=True``
(the 65-channel feature + depth warp), alone and composed; their weights
through ``weights.py``; the loss gradients; and ``api.upscale_clip``.

Weights are drawn in the port (``init_params``: non-zero biases, which
flax's init leaves at zero) and carried to flax by path. Windows stay
below 2^17 pixels a warp, where the JAX package's CPU route warps exactly.
Tolerances: the composed model rtol 2e-3, atol 5e-4; a module rtol 1e-4,
atol 1e-5 (the repo's torch oracles').
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu import config as jconfig
from video_super_resolution_tpu.api import upscale_clip as jax_upscale_clip
from video_super_resolution_tpu.models.sr_head import SRHead as JSRHead
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel
from video_super_resolution_tpu.ops.losses import charbonnier_loss as jax_charbonnier

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import ModelConfig, TrainConfig, VSRConfig
from video_super_resolution_tpu_torch.models.common import init_params
from video_super_resolution_tpu_torch.models.sr_head import SRHead
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.ops import warp as warp_mod
from video_super_resolution_tpu_torch.ops.losses import charbonnier_loss
from video_super_resolution_tpu_torch.weights import from_jax_params, to_jax_params

MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)
TINY = dict(pyramid_channels=(8, 16, 32), max_displacement=2,
            flow_estimator_channels=(16, 12), context_channels=(16, 12),
            depth_channels=8, depth_levels=2, fusion_channels=16,
            sr_channels=16, sr_blocks=2, depth_res_divisor=4)
OPTIONS = {
    "two_stage+warp_features": dict(sr_head_style="two_stage",
                                    warp_features=True),
    "espcn_mid": dict(sr_espcn_mid=32),
    "warp_features": dict(warp_features=True),
    "two_stage_x2": dict(sr_head_style="two_stage", scale=2),
}


def pair(**options):
    """(port model with seeded weights, its flax params, JAX model)."""
    cfg = ModelConfig(**TINY, **options)
    port = init_params(VSRModel(cfg), torch.Generator().manual_seed(0))
    jm = JVSRModel(cfg=jconfig.ModelConfig(**dataclasses.asdict(cfg)),
                   dtype=jnp.float32)
    return port, to_jax_params(port.state_dict()), jm


def window(seed, b=1, t=3, h=32, w=48):
    return np.random.default_rng(seed).random((b, t, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(name, monkeypatch):
    port, params, jm = pair(**OPTIONS[name])
    widths = []
    real = warp_mod.backward_warp

    def spy(img, flow, padding_mode="zeros"):
        widths.append(img.shape[-1])
        return real(img, flow, padding_mode)

    monkeypatch.setattr("video_super_resolution_tpu_torch.models.vsr."
                        "backward_warp", spy)
    x = window(0)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    s = port.cfg.scale
    assert got.shape == want.shape == (1, 32 * s, 48 * s, 3)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    f = port.cfg.fusion_channels
    assert widths == [f + 1 if port.cfg.warp_features else 4]


@pytest.mark.parametrize("scale", [2, 4])
def test_sr_head_two_stage_matches_jax(scale):
    """The head alone: scale / 2 upsample stages (raw flax leaves
    ``upsample_{u}_kernel`` / ``_bias``), ``Conv_1`` and the bilinear
    skip."""
    rng = np.random.default_rng(scale)
    fused = rng.random((2, 8, 12, 16)).astype(np.float32)
    ref = rng.random((2, 8, 12, 3)).astype(np.float32)
    port = init_params(SRHead(16, features=16, blocks=2, scale=scale,
                              style="two_stage"),
                       torch.Generator().manual_seed(scale))
    params = to_jax_params(port.state_dict())
    assert {f"upsample_{u}_kernel" for u in range(scale // 2)} <= set(params)
    jm = JSRHead(features=16, blocks=2, scale=scale, style="two_stage")
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(fused),
                               jnp.asarray(ref)))
    with torch.no_grad():
        got = port(torch.from_numpy(fused), torch.from_numpy(ref)).numpy()
    assert got.shape == want.shape == (2, 8 * scale, 12 * scale, 3)
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_weights_round_trip_at_two_stage_config():
    """The JAX two_stage + warp_features + espcn-free tree (traced, filled
    with distinct values) loads strictly and comes back leaf for leaf; the
    raw upsample leaves land on ``sr_head.upsample_{u}``, HWIO -> OIHW."""
    cfg = jconfig.serving_config(sr_head_style="two_stage",
                                 warp_features=True).model
    shapes = jax.eval_shape(JVSRModel(cfg=cfg).init, jax.random.key(0),
                            jnp.zeros((1, 3, 64, 64, 3), jnp.float32))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32),
                        shapes["params"])
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    sd = from_jax_params(tree, pcfg)
    for u in (0, 1):
        k = tree["sr_head"][f"upsample_{u}_kernel"]
        assert k.shape == (3, 3, 64, 256)
        np.testing.assert_array_equal(sd[f"sr_head.upsample_{u}.weight"].numpy(),
                                      k.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"sr_head.upsample_{u}.bias"].numpy(),
                                      tree["sr_head"][f"upsample_{u}_bias"])
    model = VSRModel(pcfg)
    model.load_state_dict(sd, strict=True)
    back = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(model.state_dict())))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(back)
    for path, leaf in flat:
        np.testing.assert_array_equal(back[path], leaf)


def test_loss_gradients_two_stage_warp_features_match_jax():
    """Every parameter's gradient of the Charbonnier loss through the
    kernels' Functions (the shuffled upsample convs and the 17-channel
    feature warp included) against jax.value_and_grad."""
    port, params, jm = pair(sr_head_style="two_stage", warp_features=True)
    rng = np.random.default_rng(1)
    lr = rng.random((2, 3, 16, 16, 3)).astype(np.float32)
    hr = rng.random((2, 64, 64, 3)).astype(np.float32)

    def loss_fn(p):
        return jax_charbonnier(jm.apply({"params": p}, jnp.asarray(lr)),
                               jnp.asarray(hr), 1e-6)

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = charbonnier_loss(port(torch.from_numpy(lr)), torch.from_numpy(hr))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = to_jax_params({k: p.grad for k, p in port.named_parameters()})
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want)
    assert ("upsample_1_kernel" in got["sr_head"]
            and "Conv_1" in got["sr_head"])
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        assert np.abs(w).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, **MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("edge_mode", ["replicate", "reflect"])
def test_upscale_clip_matches_jax(edge_mode):
    """(T, h, w, 3) -> (T, 4h, 4w, 3): one window a frame through the eval
    step, clip edges by ``edge_mode``; and equal to per-window
    ``eval_step``."""
    cfg = VSRConfig(model=ModelConfig(**TINY),
                    train=TrainConfig(compute_dtype="float32"))
    model = api.build_model(cfg, device="cpu", seed=4)
    frames = window(5, b=1, t=4, h=16, w=24)[0]
    jcfg = jconfig.VSRConfig.from_json(cfg.to_json())
    jcfg = jcfg.replace(data=dataclasses.replace(jcfg.data, edge_mode=edge_mode))
    want = jax_upscale_clip(to_jax_params(model.state_dict()), frames, jcfg,
                            edge_mode)
    got = api.upscale_clip(model, frames, edge_mode)
    assert got.shape == want.shape == (4, 64, 96, 3)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    for c, idx in enumerate([[0, 0, 1], [0, 1, 2], [1, 2, 3], [2, 3, 3]]
                            if edge_mode == "replicate" else
                            [[1, 0, 1], [0, 1, 2], [1, 2, 3], [2, 3, 2]]):
        one = api.eval_step(model, torch.from_numpy(frames[idx][None]))
        assert np.array_equal(got[c], one[0].numpy())

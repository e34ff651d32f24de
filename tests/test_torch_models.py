"""The PyTorch port's model modules against the JAX package's, on the CPU
in f32, with the flax weights carried across by path name.

Tolerances from the existing torch oracles: per module rtol 1e-4 / atol
1e-5; the flow net (warps and cost volumes compound reassociation noise)
rtol 2e-3 / atol 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.models import common as jc
from video_super_resolution_tpu.models.depth_net import DepthNet as JDepthNet
from video_super_resolution_tpu.models.feature_pyramid import (
    FeaturePyramid as JFeaturePyramid,
)
from video_super_resolution_tpu.models.flow_net import (
    ContextNetwork as JContextNetwork,
    DenseFlowEstimator as JDenseFlowEstimator,
    FlowNet as JFlowNet,
)
from video_super_resolution_tpu.models.fusion import (
    DepthGuidedFusion as JDepthGuidedFusion,
    Score1 as JScore1,
)
from video_super_resolution_tpu.models.sr_head import SRHead as JSRHead

from video_super_resolution_tpu_torch.models import common as pc
from video_super_resolution_tpu_torch.models.depth_net import DepthNet
from video_super_resolution_tpu_torch.models.feature_pyramid import FeaturePyramid
from video_super_resolution_tpu_torch.models.flow_net import (
    ContextNetwork,
    DenseFlowEstimator,
    FlowNet,
)
from video_super_resolution_tpu_torch.models.fusion import DepthGuidedFusion, Score1
from video_super_resolution_tpu_torch.models.sr_head import SRHead
from video_super_resolution_tpu_torch.weights import from_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

MODULE_TOL = dict(rtol=1e-4, atol=1e-5)
FLOW_TOL = dict(rtol=2e-3, atol=2e-4)


def bridge(jmod, port, *inputs, tol=MODULE_TOL, **kw):
    """Init jmod on inputs, carry its params into port, run both, compare."""
    jin = [jnp.asarray(a) for a in inputs]
    params = jmod.init(jax.random.key(0), *jin, **kw)
    params = jax.tree.map(np.asarray, params["params"])
    port.load_state_dict(from_jax_params(params, port), strict=True)
    want = jmod.apply({"params": params}, *jin, **kw)
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in inputs])
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def rand(rng, *shape):
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("strides,dilation,cin", [(1, 1, 8), (2, 1, 8),
                                                  (2, 1, 3), (1, 4, 16)])
def test_conv_lrelu(rng, strides, dilation, cin):
    """Stride 2 pads symmetrically (torch Conv2d semantics) on even and odd
    inputs; dilated stride-1 convs keep SAME size."""
    x = rand(rng, 2, 11, 14, cin)
    bridge(jc.ConvLReLU(12, strides=strides, dilation=dilation),
           pc.ConvLReLU(cin, 12, strides=strides, dilation=dilation), x)


def test_routed_conv_with_res(rng):
    x, res = rand(rng, 2, 9, 12, 8), rand(rng, 2, 9, 12, 6)
    jmod = jc.RoutedConv(6)
    jin = jnp.asarray(x)
    params = jax.tree.map(np.asarray,
                          jmod.init(jax.random.key(0), jin)["params"])
    port = pc.RoutedConv(8, 6)
    port.load_state_dict(from_jax_params(params, port), strict=True)
    want = jmod.apply({"params": params}, jin, res=jnp.asarray(res))
    got = port(torch.from_numpy(x), res=torch.from_numpy(res))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **MODULE_TOL)


def test_small_out_conv(rng):
    bridge(jc.SmallOutConv(2), pc.SmallOutConv(10, 2), rand(rng, 2, 7, 9, 10))


@pytest.mark.parametrize("wide", [False, True])
def test_res_block(rng, wide):
    bridge(jc.ResBlock(8, wide=wide), pc.ResBlock(8, wide=wide),
           rand(rng, 1, 10, 12, 8))


def test_pad_to_multiple_and_crop(rng):
    x = rand(rng, 1, 3, 13, 18, 3)
    want, hw = jc.pad_to_multiple(jnp.asarray(x), 8)
    got, hw2 = pc.pad_to_multiple(torch.from_numpy(x), 8)
    assert hw == hw2 == (13, 18)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pc.crop_to(got, 13, 18).numpy(), x)


def test_feature_pyramid(rng):
    ch = (8, 16, 24)
    bridge(JFeaturePyramid(ch), FeaturePyramid(ch), rand(rng, 3, 32, 48, 3))


def test_dense_flow_estimator(rng):
    ch = (16, 12, 8)
    bridge(JDenseFlowEstimator(ch), DenseFlowEstimator(20, ch),
           rand(rng, 2, 8, 12, 20))


def test_context_network(rng):
    ch = (16, 12, 8, 8, 8, 8)
    feat, flow = rand(rng, 2, 12, 16, 10), rand(rng, 2, 12, 16, 2)
    bridge(JContextNetwork(ch), ContextNetwork(12, ch), feat, flow)


@pytest.mark.parametrize("dedup", [True, False])
def test_flow_net(rng, dedup):
    """Both the deduplicated form (ref at batch B, neighbors at B*N) and the
    plain pairwise form, levels 3 -> 1 with warps and cost volumes."""
    kw = dict(pyramid_channels=(8, 16, 32), estimator_channels=(16, 12),
              context_channels=(16, 12), max_displacement=2, finest_level=1)
    ref = rand(rng, 1 if dedup else 2, 32, 48, 3)
    nbr = rand(rng, 2, 32, 48, 3)
    bridge(JFlowNet(**kw, warp_impl="gather"), FlowNet(**kw), ref, nbr,
           tol=FLOW_TOL)


@pytest.mark.parametrize("shape", [(3, 16, 24, 3), (2, 36, 60, 3)])
def test_depth_net(rng, shape):
    """W=24 and 60 trigger the replicate-pad guard (multiple of 4*2^levels);
    36x60 gives odd deep levels (9 -> 17 general-weight resizes)."""
    bridge(JDepthNet(channels=8, levels=2), DepthNet(channels=8, levels=2),
           rand(rng, *shape))


def test_score1(rng):
    bridge(JScore1(16), Score1(16), rand(rng, 2, 9, 11, 16))


@pytest.mark.parametrize("f", [16, 64])
def test_depth_guided_fusion(rng, f):
    """ScoreConv (reference half as res, res_repeat=N, bias and LReLU in the
    neighbor conv), Score1, softmax over neighbors, f32 aggregation and the
    two fusion convs."""
    b, n, h, w = 1, 2, 12, 16
    bridge(JDepthGuidedFusion(features=f), DepthGuidedFusion(features=f),
           rand(rng, b, h, w, f), rand(rng, b, n, h, w, f),
           rand(rng, b, h, w, 1), rand(rng, b, n, h, w, 1))


@pytest.mark.parametrize("features,wide", [(16, False), (64, True)])
def test_sr_head(rng, features, wide):
    """ESPCN head: trunk, subpixel conv in f32, bilinear x4 skip. At width
    64 the JAX CPU route runs its pixel-pair-packed trunk (Pallas,
    interpret mode), the same math."""
    fused, ref = rand(rng, 1, 8, 12, 16), rand(rng, 1, 8, 12, 3)
    bridge(JSRHead(features=features, blocks=2, wide_blocks=wide),
           SRHead(16, features=features, blocks=2, wide_blocks=wide),
           fused, ref)

"""Gradients through the port's three kernels' autograd Functions, on the
CPU: each Function (its CPU route and its explicit backward) against
``jax.vjp`` of the JAX package's function, run as the JAX package's own
tests run it (the conv and correlation Pallas kernels in interpret mode,
whose custom VJPs reach ``_fc_bwd`` / ``_bwd``; the warp through
``_warp_xla``), and against autograd of the port's plain version.
Tolerance: rtol 1e-4, atol 1e-5 (f32, reassociation only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.models.common import lrelu as jax_lrelu
from video_super_resolution_tpu.ops.pallas.correlation_tpu import correlation_pallas
from video_super_resolution_tpu.ops.pallas.fused_conv import fused_conv3x3 as jax_conv
from video_super_resolution_tpu.ops.warp import _warp_xla

from video_super_resolution_tpu_torch.config import ModelConfig
from video_super_resolution_tpu_torch.models.common import ResBlock, init_params
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.ops import correlation as corr_mod
from video_super_resolution_tpu_torch.ops import fused_conv as conv_mod
from video_super_resolution_tpu_torch.ops import warp as warp_mod
from video_super_resolution_tpu_torch.ops.correlation import correlation, correlation_plain
from video_super_resolution_tpu_torch.ops.fused_conv import (
    conv3x3_plain,
    fused_conv3x3,
    prepare_conv3x3_weight,
)
from video_super_resolution_tpu_torch.ops.warp import backward_warp, warp_plain
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

TOL = dict(rtol=1e-4, atol=1e-5)


def arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def leaf(a):
    return torch.from_numpy(a).requires_grad_(True)


def grads_of(out, g, *inputs):
    return torch.autograd.grad(out, inputs, torch.from_numpy(g))


def assert_grads(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


# ------------------------------------------------------------------ conv

# (B, H, W, Cin, Cout, dilation, slope, res_repeat; 0 = no residual):
# small Cin (XLA inside the JAX function), Cin >= 32 (its Pallas kernel,
# interpreted), Cin 3 (the port's folded route), dilation, identity
# activation, a residual shared by groups of 2 and 1
CONV_CASES = [(1, 8, 8, 4, 8, 1, 0.1, 0), (2, 8, 16, 3, 16, 1, 0.1, 0),
              (1, 16, 8, 35, 16, 1, 0.1, 0), (1, 8, 12, 8, 16, 2, 0.1, 0),
              (4, 8, 8, 8, 16, 1, 1.0, 2), (2, 8, 8, 33, 8, 1, 0.1, 1)]


@pytest.mark.parametrize("b,h,w,cin,cout,d,slope,rr", CONV_CASES)
def test_conv_grads_match_jax_and_plain(b, h, w, cin, cout, d, slope, rr):
    x, wt, bias, g = arrays(0, (b, h, w, cin), (cout, cin, 3, 3), (cout,),
                            (b, h, w, cout))
    wt *= 1.0 / np.sqrt(9 * cin)
    res = arrays(1, (b // rr, h, w, cout))[0] if rr else None
    jres = None if res is None else jnp.asarray(res)

    def jf(a, ww, bb, r):
        return jax_conv(a, ww, bb, slope, False, True, d, r, max(rr, 1))

    _, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(wt.transpose(2, 3, 1, 0)),
                     jnp.asarray(bias), jres)
    jdx, jdw, jdb, jdres = vjp(jnp.asarray(g))
    want = [jdx, np.asarray(jdw).transpose(3, 2, 0, 1), jdb]
    if rr:
        want.append(jdres)

    inputs = [leaf(x), leaf(wt), leaf(bias)] + ([leaf(res)] if rr else [])
    r_in = inputs[3] if rr else None
    out = fused_conv3x3(inputs[0], inputs[1], inputs[2], slope, d, r_in,
                        max(rr, 1))
    got = grads_of(out, g, *inputs)
    assert_grads(got, want)
    plain = conv3x3_plain(inputs[0], inputs[1], inputs[2], slope, d, r_in,
                          max(rr, 1))
    assert_grads(got, grads_of(plain, g, *inputs))


def test_conv_grads_through_prepared_weight_reach_params():
    """The modules' call: the kernel layout for the forward, the OIHW
    weight slice and the bias as ``params`` for the gradients."""
    x, wt, bias, g = arrays(2, (2, 8, 8, 12), (8, 12, 3, 3), (8,),
                            (2, 8, 8, 8))
    w_p, b_p, xt = leaf(wt), leaf(bias), leaf(x)
    prep = prepare_conv3x3_weight(w_p.detach(), b_p.detach(), torch.float32)
    out = fused_conv3x3(xt, prep, None, 0.1, params=(w_p, b_p))
    want = grads_of(conv3x3_plain(xt, w_p, b_p), g, xt, w_p, b_p)
    assert_grads(grads_of(out, g, xt, w_p, b_p), want)
    with pytest.raises(ValueError, match="params"):
        fused_conv3x3(xt, prep)


# ----------------------------------------------------------- correlation

# (shape, d, slope): the fused LeakyReLU, H not a multiple of 8, and a
# level smaller than the displacement window (2 x 2 at d = 4)
CORR_CASES = [((1, 8, 8, 8), 2, None), ((2, 8, 12, 16), 4, 0.1),
              ((1, 5, 7, 3), 1, None), ((2, 2, 2, 8), 4, 0.1),
              ((1, 4, 4, 12), 4, None)]


@pytest.mark.parametrize("shape,d,slope", CORR_CASES)
def test_correlation_grads_match_jax_and_plain(shape, d, slope):
    k = (2 * d + 1) ** 2
    f1, f2, g = arrays(3, shape, shape, (*shape[:3], k))

    def jf(a, b):
        out = correlation_pallas(a, b, d, True)
        return out if slope is None else jax_lrelu(out, slope)

    _, vjp = jax.vjp(jf, jnp.asarray(f1), jnp.asarray(f2))
    want = vjp(jnp.asarray(g))
    a, b = leaf(f1), leaf(f2)
    got = grads_of(correlation(a, b, d, slope=slope), g, a, b)
    assert_grads(got, want)
    assert_grads(got, grads_of(correlation_plain(a, b, d, slope), g, a, b))


# ------------------------------------------------------------------ warp

@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("shape", [(2, 9, 13, 4), (1, 6, 7, 16)])
def test_warp_grads_match_jax_and_plain(mode, shape):
    img, g = arrays(4, shape, shape)
    rng = np.random.default_rng(5)
    flow = rng.uniform(-4.0, 4.0, (*shape[:3], 2)).astype(np.float32)
    flow[:, ::3] *= 3.0                   # some taps land outside the image
    _, vjp = jax.vjp(lambda i, f: _warp_xla(i, f, mode), jnp.asarray(img),
                     jnp.asarray(flow))
    want = vjp(jnp.asarray(g))
    a, f = leaf(img), leaf(flow)
    got = grads_of(backward_warp(a, f, mode), g, a, f)
    assert_grads(got, want)
    assert_grads(got, grads_of(warp_plain(a, f, mode), g, a, f))


# ------------------------------------------------- what the backward runs

def test_backwards_never_rerun_the_forward(monkeypatch):
    """Each backward works from what the forward saved: with the plain
    forwards (the CPU route) made to raise after the forward, the
    gradients still come."""
    x, wt, bias = (leaf(a) for a in arrays(6, (1, 6, 6, 4), (4, 4, 3, 3), (4,)))
    f1, f2 = (leaf(a) for a in arrays(7, (1, 6, 6, 8), (1, 6, 6, 8)))
    img = leaf(arrays(8, (1, 6, 6, 3))[0])
    flow = leaf(np.full((1, 6, 6, 2), 0.3, np.float32))
    outs = [fused_conv3x3(x, wt, bias), correlation(f1, f2, 2, slope=0.1),
            backward_warp(img, flow)]

    def boom(*a, **k):
        raise AssertionError("forward rerun in the backward")

    monkeypatch.setattr(conv_mod, "conv3x3_plain", boom)
    monkeypatch.setattr(corr_mod, "correlation_plain", boom)
    monkeypatch.setattr(warp_mod, "warp_plain", boom)
    sum(o.sum() for o in outs).backward()
    for t in (x, wt, bias, f1, f2, img, flow):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)


def test_no_grad_forward_skips_the_autograd_functions():
    """Serving (no grad) keeps the plain forward call: no grad_fn."""
    x, wt, bias = (leaf(a) for a in arrays(9, (1, 6, 6, 4), (4, 4, 3, 3), (4,)))
    with torch.no_grad():
        assert fused_conv3x3(x, wt, bias).grad_fn is None
        assert correlation(x, x, 1).grad_fn is None
        assert backward_warp(x, torch.zeros(1, 6, 6, 2)).grad_fn is None


# ------------------------------------------------ every conv gets its grad

TINY = ModelConfig(pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
                   context_channels=(16, 16), depth_channels=8, depth_levels=2,
                   fusion_channels=16, sr_channels=16, sr_blocks=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_conv_weight_and_bias_gets_a_gradient(dtype):
    """Regression: the kernel layout used to be built without autograd, so
    no 3x3 conv parameter behind the fused conv got a gradient."""
    model = init_params(VSRModel(TINY, dtype=dtype),
                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.random((1, 3, 16, 16, 3)).astype(np.float32))
    model(lr).square().mean().backward()
    params = dict(model.named_parameters())
    assert len(params) > 60
    bad = [n for n, p in params.items()
           if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    assert not bad, f"no gradient for {bad}"


def test_resblock_convs_get_gradients():
    block = init_params(ResBlock(8, wide=True), torch.Generator().manual_seed(1))
    x = torch.randn((2, 6, 7, 8), generator=torch.Generator().manual_seed(2))
    block(x).sum().backward()
    for name in ("ConvLReLU_0.weight", "ConvLReLU_0.bias", "Conv_0.weight",
                 "Conv_0.bias"):
        grad = dict(block.named_parameters())[name].grad
        assert grad is not None and bool(grad.abs().sum() > 0), name

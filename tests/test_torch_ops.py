"""The PyTorch port's ops against the JAX package's, on the CPU in f32.

Each kernel's plain PyTorch version (what a port wrapper runs for a CPU
tensor) is held against the JAX function, and where the JAX function
reaches a Pallas kernel, against that kernel in interpret mode. Inputs are
made with numpy from a seed and handed to both. Tolerance per op: rtol
1e-4, atol 1e-5 (f32 reassociation only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.models.common import lrelu as jax_lrelu
from video_super_resolution_tpu.ops.correlation import _correlation_xla
from video_super_resolution_tpu.ops.correlation import correlation as jax_correlation
from video_super_resolution_tpu.ops.pallas.correlation_tpu import correlation_pallas
from video_super_resolution_tpu.ops.pallas.fused_conv import (
    _xla_conv,
    fused_conv3x3 as jax_fused_conv3x3,
    fused_conv3x3_packed,
)
from video_super_resolution_tpu.ops.pallas.warp_shift_tpu import warp_shift_pallas
from video_super_resolution_tpu.ops.pixel_shuffle import (
    pixel_shuffle as jax_pixel_shuffle,
    pixel_unshuffle as jax_pixel_unshuffle,
)
from video_super_resolution_tpu.ops.resize import (
    resize_bilinear as jax_resize_bilinear,
    upsample_bilinear_ps as jax_upsample_bilinear_ps,
)
from video_super_resolution_tpu.ops.warp import backward_warp as jax_backward_warp

from video_super_resolution_tpu_torch.ops.correlation import correlation, correlation_plain
from video_super_resolution_tpu_torch.ops.fused_conv import conv3x3_plain, fused_conv3x3
from video_super_resolution_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from video_super_resolution_tpu_torch.ops import resize
from video_super_resolution_tpu_torch.ops.resize import resize_bilinear, upsample_bilinear_ps
from video_super_resolution_tpu_torch.ops.warp import backward_warp, warp_plain
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

RTOL, ATOL = 1e-4, 1e-5


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def both(a):
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("r", [2, 4])
def test_pixel_shuffle_roundtrip_matches_jax(rng, r):
    x = rng.standard_normal((2, 5, 7, 3 * r * r)).astype(np.float32)
    xt, xj = both(x)
    close(pixel_shuffle(xt, r), jax_pixel_shuffle(xj, r), 0, 0)
    y = rng.standard_normal((2, 5 * r, 7 * r, 3)).astype(np.float32)
    yt, yj = both(y)
    close(pixel_unshuffle(yt, r), jax_pixel_unshuffle(yj, r), 0, 0)


@pytest.mark.parametrize("shape,out", [
    ((2, 9, 15, 3), (18, 30)),      # both axes x2: upsample_bilinear_ps
    ((1, 17, 30, 2), (68, 120)),    # both axes x4 (flow to full res)
    ((3, 9, 16, 4), (17, 32)),      # H general weights, W integer x2
    ((1, 16, 24, 3), (8, 12)),      # exact 1/2 on both axes: pair means
    ((2, 32, 48, 3), (8, 12)),      # 1/4 (the depth-branch divisor)
    ((1, 11, 13, 2), (7, 20)),      # general weights both ways
])
def test_resize_bilinear_matches_jax(rng, shape, out):
    x = rng.random(shape).astype(np.float32)
    xt, xj = both(x)
    close(resize_bilinear(xt, *out), jax_resize_bilinear(xj, *out))


@pytest.mark.parametrize("tables", ["built", "kept"])
def test_resize_bilinear_serving_depth_ratio(rng, tables):
    """544x960 -> 136x240 takes the general-weights branch on H (4:1) and
    W; this is the depth branch's exact ratio at serving size. Its tap
    tables either built by this call or kept from an earlier one."""
    x = rng.random((1, 544, 960, 3)).astype(np.float32)
    xt, xj = both(x)
    drop_tables((544, 136, False), (960, 240, False))
    if tables == "kept":
        resize_bilinear(xt, 136, 240)
    close(resize_bilinear(xt, 136, 240), jax_resize_bilinear(xj, 136, 240))


def drop_tables(*keys):
    for n_in, n_out, cubic in keys:
        resize._TABLES.pop((n_in, n_out, cubic, torch.device("cpu")), None)


def gather_from_numpy(x, axis, out_size, cubic):
    """One axis's tap gather with its tables made in numpy and handed over
    at each call: the resize before its tables were kept."""
    idx, w = resize._resample_weights(x.shape[axis], out_size, cubic)
    idx_t, w_t = torch.from_numpy(idx), torch.from_numpy(w)
    wshape = [1] * x.ndim
    wshape[axis] = out_size
    out = None
    for k in range(idx.shape[1]):
        term = (x.index_select(axis, idx_t[:, k]).to(torch.float32)
                * w_t[:, k].reshape(wshape))
        out = term if out is None else out + term
    return out


@pytest.mark.parametrize("kind,shape,out", [
    ("bilinear", (1, 544, 960, 3), (136, 240)),    # the depth branch's 1/4
    ("bilinear", (1, 11, 13, 2), (7, 19)),
    ("bicubic", (2, 32, 48, 3), (8, 12)),          # degrade's MATLAB preset
    ("bicubic", (32, 48), (64, 96)),
    ("bicubic", (2, 3, 32, 48, 3), (32, 20)),
])
@pytest.mark.parametrize("tables", ["built", "kept"])
def test_resize_with_kept_tables_is_the_uncached_resize(rng, kind, shape, out,
                                                        tables):
    """The resize reading its kept tap tables equals, bit for bit, the one
    that made them from numpy at each call, H then W."""
    x = torch.from_numpy(rng.random(shape).astype(np.float32))
    h_ax = x.ndim - 3 if x.ndim >= 3 else 0
    cubic = kind == "bicubic"
    fn = resize.resize_bicubic if cubic else resize_bilinear
    drop_tables((shape[h_ax], out[0], cubic), (shape[h_ax + 1], out[1], cubic))
    if tables == "kept":
        fn(x, *out)
    want = gather_from_numpy(gather_from_numpy(x, h_ax, out[0], cubic),
                             h_ax + 1, out[1], cubic)
    assert torch.equal(fn(x, *out), want)


@pytest.mark.parametrize("n_in,n_out,cubic", [
    (544, 136, False), (960, 240, False), (13, 7, False),
    (32, 8, True), (48, 96, True), (48, 20, True)])
def test_resize_tables_are_the_numpy_tables(n_in, n_out, cubic):
    """Each tap's kept index and weight vector is ``_resample_weights``'
    column, exactly, built once for each (sizes, kernel, device)."""
    idx, w = resize._resample_weights(n_in, n_out, cubic)
    taps = resize._device_tables(n_in, n_out, cubic, torch.device("cpu"))
    assert len(taps) == idx.shape[1]
    for k, (i, wk) in enumerate(taps):
        assert i.dtype == torch.int64 and wk.dtype == torch.float32
        assert i.is_contiguous() and wk.is_contiguous()
        assert np.array_equal(i.numpy(), idx[:, k])
        assert np.array_equal(wk.numpy(), w[:, k])
    assert resize._device_tables(n_in, n_out, cubic, torch.device("cpu")) is taps


@pytest.mark.parametrize("r", [2, 4])
def test_upsample_bilinear_ps_matches_jax(rng, r):
    x = rng.random((2, 6, 10, 3)).astype(np.float32)
    xt, xj = both(x)
    close(upsample_bilinear_ps(xt, r), jax_upsample_bilinear_ps(xj, r))


def _conv_inputs(rng, b, h, w, cin, cout, res_b=None):
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    res = (None if res_b is None else
           rng.standard_normal((res_b, h, w, cout)).astype(np.float32))
    return x, k, bias, res


def _port_conv(x, k, bias, **kw):
    """Port call with the JAX HWIO kernel carried to OIHW."""
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    res = kw.pop("res", None)
    if res is not None:
        res = torch.from_numpy(res)
    return fused_conv3x3(torch.from_numpy(x), w, torch.from_numpy(bias),
                         res=res, **kw)


@pytest.mark.parametrize("case", [
    dict(b=2, cin=32, cout=16, slope=0.1, dilation=1),
    dict(b=1, cin=48, cout=24, slope=0.1, dilation=2),
    dict(b=2, cin=32, cout=16, slope=1.0, dilation=1, res_repeat=2),
    dict(b=1, cin=32, cout=16, slope=0.1, dilation=1, res_repeat=1),
    dict(b=1, cin=32, cout=16, slope=0.1, dilation=1, shuffle=True),
    # the two_stage head's upsample stage: features -> 4 x features
    dict(b=2, cin=32, cout=128, slope=0.1, dilation=1, shuffle=True),
], ids=["plain", "dilated", "res_repeat2", "res", "shuffle", "shuffle_x4"])
def test_conv_plain_matches_pallas_kernel(rng, case):
    """fused_conv3x3's CPU path vs the Pallas kernel in interpret mode
    (cin >= 32 so the JAX wrapper does not route to XLA)."""
    b, cin, cout = case["b"], case["cin"], case["cout"]
    d = case["dilation"]
    rr = case.get("res_repeat")
    x, k, bias, res = _conv_inputs(rng, b, 8, 16, cin, cout,
                                   None if rr is None else b // rr)
    shuffle = case.get("shuffle", False)
    want = jax_fused_conv3x3(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), case["slope"],
        shuffle, True, d, None if res is None else jnp.asarray(res), rr or 1)
    got = _port_conv(x, k, bias, slope=case["slope"], dilation=d, res=res,
                     res_repeat=rr or 1, shuffle=shuffle)
    assert tuple(got.shape) == tuple(want.shape)
    close(got, want)


@pytest.mark.parametrize("cin,d", [(3, 1), (65, 1), (16, 4)])
def test_conv_plain_matches_xla_conv(rng, cin, d):
    """Thin and odd channel counts and wide dilations (the context net's
    d=16 is this path) against the JAX reference conv."""
    x, k, bias, _ = _conv_inputs(rng, 2, 12, 20, cin, 8)
    want = _xla_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), 0.1,
                     False, d)
    close(_port_conv(x, k, bias, slope=0.1, dilation=d), want)


def test_conv_plain_rounds_once_in_bf16(rng):
    """bf16 path: f32 accumulation of the bf16 values, one rounding at the
    end (the kernel's contract), not a rounding of the conv before bias."""
    x, k, bias, _ = _conv_inputs(rng, 1, 6, 8, 16, 8)
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    bb = torch.from_numpy(bias).to(torch.bfloat16)
    got = conv3x3_plain(xb, w, bb, 0.1)
    assert got.dtype == torch.bfloat16
    ref = conv3x3_plain(xb.float(), w.to(torch.bfloat16).float(), bb.float(), 0.1)
    assert torch.equal(got, ref.to(torch.bfloat16))


def test_packed_call_sites_match_port_conv(rng):
    """K2's call-site math: the pixel-pair-packed Pallas conv (interpret)
    with a res operand, and its segmented input (a lane-concat of two
    packed groups), equal the port's unpacked conv with res and a channel
    concat."""
    b, h, w, f = 1, 8, 16, 32
    xa = rng.standard_normal((b, h, w, f)).astype(np.float32)
    xb = rng.standard_normal((b, h, w, f)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 2 * f, 64)) / np.sqrt(18 * f)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    res = rng.standard_normal((b, h, w, 64)).astype(np.float32)
    x = np.concatenate([xa, xb], -1)
    want = fused_conv3x3_packed(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), 1.0, False, False,
        True, jnp.asarray(res), 1)
    close(_port_conv(x, k, bias, slope=1.0, res=res), want)
    seg = np.concatenate([xa.reshape(b, h, w // 2, 2 * f),
                          xb.reshape(b, h, w // 2, 2 * f)], -1)
    want = fused_conv3x3_packed(
        jnp.asarray(seg), jnp.asarray(k), jnp.asarray(bias), 0.1, True, False,
        True, None, 1, True)
    close(_port_conv(x, k, bias, slope=0.1), want)


@pytest.mark.parametrize("shape,d", [((2, 8, 12, 16), 2), ((1, 9, 10, 8), 4),
                                     ((2, 5, 7, 32), 4)])
def test_correlation_plain_matches_pallas_kernel(rng, shape, d):
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    want = correlation_pallas(jnp.asarray(f1), jnp.asarray(f2), d, True)
    got = correlation(torch.from_numpy(f1), torch.from_numpy(f2), d)
    assert tuple(got.shape) == (*shape[:3], (2 * d + 1) ** 2)
    close(got, want)
    close(got, _correlation_xla(jnp.asarray(f1), jnp.asarray(f2), d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2, 4])
def test_correlation_fused_epilogue_matches_flow_net(rng, d, dtype):
    """correlation(..., slope, out_dtype) against the JAX flow net's
    lrelu(correlation(fr, warped)).astype(dtype), inputs in dtype. bf16:
    the two f32 sums may round to neighbouring bf16 values (rtol 2^-7)."""
    shape = (2, 7, 11, 24)
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want = jax_lrelu(jax_correlation(jnp.asarray(f1, jdt), jnp.asarray(f2, jdt),
                                     d), 0.1).astype(jdt)
    got = correlation(torch.from_numpy(f1).to(tdt), torch.from_numpy(f2).to(tdt),
                      d, slope=0.1, out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    rtol = RTOL if dtype == "float32" else 2.0 ** -7
    close(got.float(), np.asarray(want.astype(jnp.float32)), rtol=rtol)


@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [4, 32])
def test_warp_plain_matches_gather(rng, mode, c):
    """Exact for any flow, including taps far outside the image."""
    img = rng.standard_normal((2, 10, 14, c)).astype(np.float32)
    flow = (4.0 * rng.standard_normal((2, 10, 14, 2))).astype(np.float32)
    want = jax_backward_warp(jnp.asarray(img), jnp.asarray(flow), mode,
                             impl="gather")
    got = backward_warp(torch.from_numpy(img), torch.from_numpy(flow), mode)
    close(got, want)


def test_warp_plain_matches_pallas_kernel_in_budget(rng):
    """Inside the TPU kernel's tap budget (smooth flow) the Pallas warp in
    interpret mode equals the port's exact gather."""
    b, h, w, c = 1, 16, 128, 4
    ys, xs = np.mgrid[0:h, 0:w]
    fx = 3.0 * np.sin(xs / 40.0) + 1.5
    fy = 1.8 * np.cos(ys / 25.0) - 1.0
    flow = np.stack([np.broadcast_to(fx, (b, h, w)),
                     np.broadcast_to(fy, (b, h, w))], -1).astype(np.float32)
    img = rng.random((b, h, w, c)).astype(np.float32)
    want = warp_shift_pallas(jnp.asarray(img), jnp.asarray(flow), interpret=True)
    close(warp_plain(torch.from_numpy(img), torch.from_numpy(flow)), want,
          1e-6, 1e-6)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A wrapper runs its plain version only for CPU tensors; any other
    device launches the kernel or raises, never falls back."""
    x = torch.zeros((1, 4, 4, 8), device="meta")
    w = torch.zeros((8, 8, 3, 3), device="meta")
    b = torch.zeros((8,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv3x3(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        correlation(x, x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        backward_warp(x, torch.zeros((1, 4, 4, 2), device="meta"))


def test_wrapper_shape_checks():
    x = torch.zeros((2, 4, 4, 8))
    w = torch.zeros((8, 8, 3, 3))
    b = torch.zeros((8,))
    with pytest.raises(ValueError, match="res"):
        fused_conv3x3(x, w, b, res=torch.zeros((2, 4, 4, 8)), res_repeat=2)
    with pytest.raises(ValueError):
        fused_conv3x3(x, torch.zeros((8, 4, 3, 3)), b)
    with pytest.raises(ValueError):
        correlation_plain(x, torch.zeros((2, 4, 5, 8)), 2)
    with pytest.raises(ValueError):
        warp_plain(x, torch.zeros((2, 4, 4, 2)), "reflect")

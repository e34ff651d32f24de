"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). On a GPU machine with nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: f32 rtol 1e-4 / atol 1e-4 (TF32 off, reassociation only), bf16
rtol 2e-2 / atol 2e-2 (one bf16 rounding of the output).
"""

import pytest
import torch

from video_super_resolution_tpu_torch.ops.correlation import correlation, correlation_plain
from video_super_resolution_tpu_torch.ops.fused_conv import (
    conv3x3_plain,
    conv3x3_plan,
    fused_conv3x3,
    prepare_conv3x3_weight,
)
from video_super_resolution_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from video_super_resolution_tpu_torch.ops.warp import backward_warp, warp_plain

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def rn(gen, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def close(a, b, dtype):
    torch.cuda.synchronize()
    torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,cin,cout,d,rr", [
    (1, 17, 30, 3, 64, 1, 0), (2, 19, 33, 115, 48, 2, 0),
    (2, 16, 40, 66, 64, 1, 2), (1, 9, 16, 256, 256, 16, 1),
    # Cin a multiple of 8: x read by TMA as it is
    (1, 8, 40, 64, 128, 1, 0), (1, 12, 24, 128, 64, 1, 1),
    (1, 9, 20, 256, 96, 2, 0),
    # odd Cin: channels padded to a multiple of 8 first
    (2, 11, 37, 65, 64, 1, 2), (1, 7, 19, 565, 128, 1, 0),
    (1, 10, 30, 3, 48, 1, 1),
    # Cin <= 3: taps folded into 32 channels, here dilated and Cout not a
    # multiple of 8; Cin 4 takes the padded route
    (2, 12, 20, 3, 20, 4, 0), (1, 9, 11, 4, 72, 1, 1),
    # Cout 48 / 32 / 20 / 200 inside or across output tiles
    (2, 13, 21, 115, 32, 3, 0), (1, 6, 10, 32, 20, 1, 1),
    (3, 5, 8, 24, 200, 1, 0),
    # M and W not multiples of the tile, dilation 16 with H < 32
    (1, 33, 70, 16, 16, 1, 0), (1, 20, 24, 96, 64, 16, 0),
    # small M, deep K: split-K
    (2, 17, 30, 627, 32, 1, 0), (2, 34, 60, 179, 128, 1, 0)])
def test_conv3x3_kernel_matches_plain(gen, dtype, b, h, w, cin, cout, d, rr):
    x = rn(gen, (b, h, w, cin), dtype)
    wt = rn(gen, (cout, cin, 3, 3)) / (9 * cin) ** 0.5
    bias = rn(gen, (cout,), dtype)
    res = rn(gen, (b // rr, h, w, cout), dtype) if rr else None
    before = fused_conv3x3.launches
    out = fused_conv3x3(x, wt, bias, 0.1, d, res, max(rr, 1))
    assert fused_conv3x3.launches == before + 1
    assert out.dtype == dtype and out.is_cuda
    close(out, conv3x3_plain(x, wt, bias, 0.1, d, res, max(rr, 1)), dtype)


@pytest.mark.cuda
def test_conv3x3_kernel_f32_res_with_bf16_input(gen):
    x = rn(gen, (1, 12, 20, 64), torch.bfloat16)
    wt = rn(gen, (48, 64, 3, 3)) / 24.0
    bias = rn(gen, (48,), torch.bfloat16)
    res = rn(gen, (1, 12, 20, 48))
    close(fused_conv3x3(x, wt, bias, 1.0, res=res),
          conv3x3_plain(x, wt, bias, 1.0, res=res), torch.bfloat16)


@pytest.mark.cuda
def test_conv3x3_split_k_is_reproducible(gen):
    x = rn(gen, (2, 17, 30, 627))
    wt = rn(gen, (32, 627, 3, 3)) / 75.0
    bias = rn(gen, (32,))
    assert conv3x3_plan(x.shape, 32, x.dtype).splits > 1
    prep = prepare_conv3x3_weight(wt, bias, x.dtype)
    a, b = fused_conv3x3(x, prep), fused_conv3x3(x, prep)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    close(a, conv3x3_plain(x, wt, bias), torch.float32)


@pytest.mark.cuda
def test_conv3x3_kernel_rejects_misaligned_input(gen):
    flat = rn(gen, (8 * 8 * 16 + 1,), torch.bfloat16)
    x = flat[1:].view(1, 8, 8, 16)           # contiguous, 2 bytes off
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        fused_conv3x3(x, rn(gen, (8, 16, 3, 3)), rn(gen, (8,)))


# (shape, d): the four serving levels; d 1..3; C not a whole 16-byte unit
# (3, 20, 65); H and W not multiples of the tile (4 x 32, 2 x 32, 1 x 32);
# W below the tile width; H = 1; ragged images with more tiles than two
# waves
CORR_CASES = [((2, 136, 240, 32), 4), ((2, 68, 120, 64), 4),
              ((2, 34, 60, 96), 4), ((2, 17, 30, 128), 4),
              ((1, 21, 70, 32), 4), ((2, 9, 13, 16), 2), ((1, 8, 8, 20), 1),
              ((1, 9, 13, 3), 1), ((2, 11, 37, 20), 2), ((1, 21, 70, 65), 3),
              ((1, 5, 40, 128), 4), ((3, 6, 7, 65), 4), ((2, 1, 19, 20), 4),
              ((1, 1, 1, 3), 2), ((1, 3, 33, 128), 3),
              ((1, 137, 250, 32), 4), ((1, 137, 250, 20), 3)]
# (slope, out_dtype): the default, and the flow net's fused epilogue
EPILOGUES = [(None, torch.float32), (0.1, torch.float32),
             (0.1, torch.bfloat16), (None, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,d", CORR_CASES)
@pytest.mark.parametrize("slope,out_dtype", EPILOGUES)
def test_correlation_kernel_matches_plain(gen, dtype, shape, d, slope, out_dtype):
    f1, f2 = rn(gen, shape, dtype), rn(gen, shape, dtype)
    before = correlation.launches
    out = correlation(f1, f2, d, slope=slope, out_dtype=out_dtype)
    assert correlation.launches == before + 1
    assert out.dtype == out_dtype and out.shape == (*shape[:3], (2 * d + 1) ** 2)
    close(out, correlation_plain(f1, f2, d, slope, out_dtype), out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_correlation_split_channels_is_reproducible(gen, dtype):
    """At 17 x 30 the block splits the channel loop over its warps; the
    fixed-order reduction gives the same bits on every call."""
    f1, f2 = rn(gen, (2, 17, 30, 128), dtype), rn(gen, (2, 17, 30, 128), dtype)
    a, b = correlation(f1, f2, 4, 0.1), correlation(f1, f2, 4, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [1, 3, 4, 5, 8, 32, 65, 96])
def test_warp_kernel_matches_plain(gen, dtype, mode, c):
    """Batch 3, odd W, and every fifth row sent 40-100 pixels outside."""
    img = rn(gen, (3, 13, 37, c), dtype)
    flow = rn(gen, (3, 13, 37, 2)) * 6.0
    flow[:, ::5] *= 15.0
    before = backward_warp.launches
    out = backward_warp(img, flow, mode)
    assert backward_warp.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, warp_plain(img, flow, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 544, 960, 4), (2, 34, 60, 96),
                                   (2, 68, 120, 64), (2, 136, 240, 32)])
def test_warp_kernel_serving_shapes(gen, dtype, shape):
    img = rn(gen, shape, dtype)
    flow = rn(gen, (*shape[:3], 2)) * 3.0
    out = backward_warp(img, flow)
    torch.cuda.synchronize()
    assert torch.equal(out, warp_plain(img, flow))


# the two_stage head's upsample stages (64 -> 256, shuffled) and the
# warp_features model's feature + depth warp (C = 65, bf16; 33 is another
# odd C): shapes of the serving window cut to a few rows
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w", [(1, 34, 960), (1, 20, 1920)])
def test_conv3x3_kernel_shuffled_upsample(gen, dtype, b, h, w):
    x = rn(gen, (b, h, w, 64), dtype)
    wt = rn(gen, (256, 64, 3, 3)) / 24.0
    bias = rn(gen, (256,), dtype)
    before = fused_conv3x3.launches
    out = fused_conv3x3(x, wt, bias, 0.1, shuffle=True)
    assert fused_conv3x3.launches == before + 1
    assert tuple(out.shape) == (b, 2 * h, 2 * w, 64) and out.dtype == dtype
    close(out, pixel_shuffle(conv3x3_plain(x, wt, bias, 0.1), 2), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [65, 33])
def test_warp_kernel_odd_channels_at_feature_warp_shape(gen, dtype, mode, c):
    img = rn(gen, (2, 68, 960, c), dtype)
    flow = rn(gen, (2, 68, 960, 2)) * 3.0
    flow[:, ::7] *= 20.0
    out = backward_warp(img, flow, mode)
    torch.cuda.synchronize()
    assert torch.equal(out, warp_plain(img, flow, mode))


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(gen):
    x = rn(gen, (1, 8, 8, 16))
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv3x3(x.transpose(1, 2), rn(gen, (8, 16, 3, 3)), rn(gen, (8,)))
    with pytest.raises(ValueError, match="d <="):
        correlation(x, x, 5)
    with pytest.raises(TypeError):
        backward_warp(x, rn(gen, (1, 8, 8, 2), torch.bfloat16))


# ------------------------------------------------------------ gradients
# Each kernel's autograd Function (its explicit backward) against autograd
# of its plain version, at the train step's shapes (VSRConfig(): LR crop
# 64, batch 4, window 3). A gradient is a sum over many pixels, so it is
# compared after division by the reference's largest magnitude. The
# LeakyReLU's derivative jumps at 0: where the kernel's and the plain
# version's pre-activations (equal up to rounding) straddle 0, the two
# derivatives differ by 0.9 g. So the reference takes the activation's
# derivative from the kernel's output, as the backward does, and autograd
# of the plain version without the activation gives the rest. (The
# derivative itself is held against JAX on the CPU,
# tests/test_torch_autograd.py.)


def lrelu_grad(out, g, slope):
    return torch.where(out >= 0, g, g * slope)

def grad_close(got, want, dtype):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        s = b.float().abs().max().clamp(min=1e-30)
        torch.testing.assert_close(a.float() / s, b.float() / s, **TOL[dtype])


# (B, H, W, Cin, Cout, dilation, slope, res_repeat; 0 = no residual): SR
# trunk, trunk conv with its skip, score conv with the shared reference
# half, frame encoder (Cin 3), flow estimator, dilated context conv,
# pyramid level 0
TRAIN_CONV = [(4, 64, 64, 64, 128, 1, 0.1, 0), (4, 64, 64, 128, 64, 1, 1.0, 1),
              (8, 64, 64, 66, 64, 1, 0.1, 2), (12, 64, 64, 3, 64, 1, 0.1, 0),
              (8, 16, 16, 115, 128, 1, 0.1, 0), (8, 16, 16, 128, 128, 4, 0.1, 0),
              (12, 32, 32, 16, 16, 1, 0.1, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,cin,cout,d,slope,rr", TRAIN_CONV)
def test_conv3x3_backward_matches_plain_autograd(gen, dtype, b, h, w, cin,
                                                 cout, d, slope, rr):
    x = rn(gen, (b, h, w, cin), dtype).requires_grad_()
    wt = (rn(gen, (cout, cin, 3, 3)) / (9 * cin) ** 0.5).requires_grad_()
    bias = (rn(gen, (cout,)) * 0.1).requires_grad_()
    res = rn(gen, (b // rr, h, w, cout), dtype).requires_grad_() if rr else None
    g = rn(gen, (b, h, w, cout), dtype)
    ins = [x, wt, bias] + ([res] if rr else [])
    before = fused_conv3x3.launches
    out = fused_conv3x3(x, wt, bias, slope, d, res, max(rr, 1))
    got = torch.autograd.grad(out, ins, g)
    assert fused_conv3x3.launches == before + 1      # none in the backward
    want = torch.autograd.grad(
        conv3x3_plain(x, wt, bias, 1.0, d, res, max(rr, 1)), ins,
        lrelu_grad(out, g, slope))
    grad_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv3x3_backward_shuffled_upsample(gen, dtype):
    """The two_stage head's stage: gradients through the shuffle too."""
    x = rn(gen, (2, 32, 32, 64), dtype).requires_grad_()
    wt = (rn(gen, (256, 64, 3, 3)) / 24.0).requires_grad_()
    bias = (rn(gen, (256,)) * 0.1).requires_grad_()
    g = rn(gen, (2, 64, 64, 64), dtype)
    out = fused_conv3x3(x, wt, bias, 0.1, shuffle=True)
    got = torch.autograd.grad(out, [x, wt, bias], g)
    lin = pixel_shuffle(conv3x3_plain(x, wt, bias, 1.0), 2)
    want = torch.autograd.grad(lin, [x, wt, bias], lrelu_grad(out, g, 0.1))
    grad_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv3x3_backward_through_prepared_weight(gen, dtype):
    x = rn(gen, (4, 64, 64, 64), dtype).requires_grad_()
    wt = (rn(gen, (64, 64, 3, 3)) / 24.0).requires_grad_()
    bias = (rn(gen, (64,)) * 0.1).requires_grad_()
    prep = prepare_conv3x3_weight(wt.detach(), bias.detach(), dtype)
    g = rn(gen, (4, 64, 64, 64), dtype)
    out = fused_conv3x3(x, prep, None, 0.1, params=(wt, bias))
    got = torch.autograd.grad(out, [x, wt, bias], g)
    want = torch.autograd.grad(conv3x3_plain(x, wt, bias, 1.0), [x, wt, bias],
                               lrelu_grad(out, g, 0.1))
    grad_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 16, 16, 32), (8, 8, 8, 64),
                                   (8, 4, 4, 96), (8, 2, 2, 128)])
def test_correlation_backward_matches_plain_autograd(gen, dtype, shape):
    """The flow net's call: d = 4, fused LeakyReLU, output in the compute
    dtype; at 4 x 4 and 2 x 2 the window is mostly zero padding."""
    f1 = rn(gen, shape, dtype).requires_grad_()
    f2 = rn(gen, shape, dtype).requires_grad_()
    g = rn(gen, (*shape[:3], 81), dtype)
    before = correlation.launches
    out = correlation(f1, f2, 4, 0.1, dtype)
    got = torch.autograd.grad(out, [f1, f2], g)
    assert correlation.launches == before + 1
    want = torch.autograd.grad(correlation_plain(f1, f2, 4, None, dtype),
                               [f1, f2], lrelu_grad(out, g, 0.1))
    grad_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("shape,dtype", [
    ((8, 64, 64, 4), torch.float32), ((8, 16, 16, 32), torch.float32),
    ((8, 16, 16, 32), torch.bfloat16), ((8, 8, 8, 64), torch.bfloat16),
    ((8, 4, 4, 96), torch.bfloat16),
    # the warp_features model's feature + depth warp
    ((8, 64, 64, 65), torch.float32), ((8, 64, 64, 65), torch.bfloat16)])
def test_warp_backward_matches_plain_autograd(gen, mode, shape, dtype):
    """The frame + depth warp (f32, C = 4) and the feature warps (bf16 in
    the train step); flows of +-3 px, some taps outside the image."""
    img = rn(gen, shape, dtype).requires_grad_()
    flow = (rn(gen, (*shape[:3], 2)) * 3.0).requires_grad_()
    g = rn(gen, shape, dtype)
    before = backward_warp.launches
    got = torch.autograd.grad(backward_warp(img, flow, mode), [img, flow], g)
    assert backward_warp.launches == before + 1
    want = torch.autograd.grad(warp_plain(img, flow, mode), [img, flow], g)
    grad_close(got, want, dtype)

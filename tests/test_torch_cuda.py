"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: they skip without a CUDA device (the kernels have no CPU
mode). On a GPU machine with nvcc:

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerances: f32 rtol 1e-4 / atol 1e-4 (TF32 off, reassociation only), bf16
rtol 2e-2 / atol 2e-2 (one bf16 rounding of the output).
"""

import numpy as np
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
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

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


# the tensor-parallel SR trunk (parallel/tensor.py) at n model ranks, C = 64:
# conv1 64 -> 128/n with the LReLU, conv2 128/n -> 64 at slope 1 with no
# bias and no residual; the partial sums of the n ranks, plus the bias and
# the skip added once, are the unsharded ResBlock (serving rows cut to 34)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [2, 4])
def test_conv3x3_kernel_tp_trunk_shapes(gen, dtype, n):
    from video_super_resolution_tpu_torch.models.common import ResBlock

    x = rn(gen, (1, 34, 960, 64), dtype)
    block = ResBlock(64, dtype=dtype, wide=True).cuda()
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(rn(gen, p.shape) / (24.0 if p.ndim == 4 else 10.0))
        c1, c2 = block.ConvLReLU_0, block.Conv_0
        k = 128 // n
        total = torch.zeros((1, 34, 960, 64), device="cuda")
        for m in range(n):
            sl = slice(m * k, (m + 1) * k)
            w1, b1, w2 = c1.weight[sl], c1.bias[sl], c2.weight[:, sl]
            before = fused_conv3x3.launches
            h = fused_conv3x3(x, prepare_conv3x3_weight(w1, b1, dtype))
            part = fused_conv3x3(h, prepare_conv3x3_weight(
                w2, torch.zeros(64, device="cuda"), dtype), slope=1.0)
            assert fused_conv3x3.launches == before + 2
            close(h, conv3x3_plain(x, w1, b1), dtype)
            close(part, conv3x3_plain(h, w2, torch.zeros(64, device="cuda"),
                                      1.0), dtype)
            total += part.float()
        got = (total + c2.bias + x.float()).to(dtype)
        close(got, block(x), dtype)


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


# ------------------------------------------ the bench tools at tiny sizes

def tiny_cfg(dtype="bfloat16"):
    from video_super_resolution_tpu_torch.config import (
        DataConfig,
        ModelConfig,
        TrainConfig,
        VSRConfig,
    )

    model = ModelConfig(
        pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
        context_channels=(16, 16), depth_channels=8, depth_levels=2,
        fusion_channels=16, sr_blocks=2, sr_channels=16)
    return VSRConfig(model=model, data=DataConfig(crop_size=8, batch_size=2),
                     train=TrainConfig(compute_dtype=dtype))


TOOL_CLIPS = dict(n_clips=2, frames=3, h=48, w=64)


def finite_positive(rec):
    return all(v > 0 and v < float("inf") for v in rec.values()
               if isinstance(v, float))


@pytest.mark.cuda
def test_bench_dispatch_on_the_card(gen, tmp_path):
    from video_super_resolution_tpu_torch.tools import bench_dispatch as bd

    rec = bd.run(steps=2, k=2, root=str(tmp_path), device="cuda",
                 cfg=tiny_cfg(), clips=TOOL_CLIPS, warm=2, emit=lambda s: None)
    assert rec["device"] != "cpu" and finite_positive(rec)
    assert rec["device_events_per_step"] > 0


@pytest.mark.cuda
def test_bench_loader_on_the_card(gen, tmp_path):
    from video_super_resolution_tpu_torch.tools import bench_loader as bl

    rec = bl.run("python", 2, 3, str(tmp_path), "cuda", cfg=tiny_cfg(),
                 clips=TOOL_CLIPS, loader_batches=(1, 4), emit=lambda s: None)
    assert rec["loader"] == "python" and finite_positive(rec)


@pytest.mark.cuda
def test_bench_scaling_on_the_card(gen, monkeypatch):
    """f32 (TF32 off, in the ranks through cuBLAS's and cuDNN's
    NVIDIA_TF32_OVERRIDE): the 2-rank streamed frames against the
    unsharded model on the card, per window with replicated clip edges."""
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.data.dataset import sliding_window_indices
    from video_super_resolution_tpu_torch.tools import bench_scaling as bs

    monkeypatch.setenv("NVIDIA_TF32_OVERRIDE", "0")
    cfg = tiny_cfg("float32")
    payload, outs = bs.run([1, 2], 32, 64, 2, 1, "cuda", cfg=cfg,
                           emit=lambda s: None)
    frames, out = outs[2]
    model = api.build_model(cfg, "cuda", seed=0)
    windows = torch.stack([torch.from_numpy(frames[sliding_window_indices(
        4, c, 3)]) for c in range(4)]).cuda()
    with torch.no_grad():
        want = model(windows)
    close(torch.from_numpy(out).cuda(), want, torch.float32)
    for rec in payload["results"]:
        assert all(min(c.values()) > 0 for c in rec["launches"])


@pytest.mark.cuda
def test_bench_roofline_on_the_card(gen):
    """Tiny shapes: every rate finite, no share above the datasheet; each
    ``k1_`` row against its ``F.conv2d`` row."""
    from video_super_resolution_tpu_torch.tools import bench_roofline as br

    shapes = {"matmul": (256,), "matmul_f32": (256,), "im2col": (1024, 16, 32),
              "conv": ((1, 24, 40, 64, 64), (2, 20, 24, 3, 32)),
              "axpy": 1 << 20, "transpose": (2, 16, 24, 8)}
    lines = br.run("cuda", shapes=shapes, emit=lambda s: None)
    assert all(r["peak_share"] <= 1.05 and r["ms"] > 0 for r in lines)
    ops = {op.name: op for op in br.roofline_ops("cuda", shapes)}
    for name, op in ops.items():
        if name.startswith("k1_"):
            ref = ops[name[3:]]
            close(op.fn(*op.make_args()), ref.fn(*ref.make_args()),
                  torch.bfloat16)


# ------------------------- the library routes of the kernel-against-library tools

# (B, H, W, Cin, Cout, dilation, res_repeat or 0 for no res, shuffle): the
# JAX conv tool's four shapes, the SR trunk conv with its skip, the
# two_stage head's upsample_0, a dilated depth-net conv
LIB_CONV = [(b, h, w, ci, co, 1, 0, False)
            for (b, h, w, ci, co) in ((1, 544, 960, 64, 64),
                                      (2, 544, 960, 131, 64),
                                      (2, 136, 240, 243, 128),
                                      (3, 272, 480, 192, 64))] + [
    (1, 540, 960, 64, 64, 1, 1, False), (1, 540, 960, 64, 256, 1, 0, True),
    (3, 136, 240, 64, 64, 2, 0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,w,cin,cout,d,rr,shuffle", LIB_CONV)
def test_conv3x3_library_matches_plain(gen, dtype, b, h, w, cin, cout, d, rr,
                                       shuffle):
    """The library route (F.conv2d in the input's dtype, then the f32
    epilogue: in bf16 one more rounding than the plain version) at the
    model's shapes, TOL."""
    from video_super_resolution_tpu_torch.tools.bench_conv import conv3x3_library

    x = rn(gen, (b, h, w, cin), dtype)
    wt = rn(gen, (cout, cin, 3, 3)) / (9 * cin) ** 0.5
    bias = rn(gen, (cout,)) * 0.1
    res = rn(gen, (b // rr, h, w, cout), dtype) if rr else None
    got = conv3x3_library(x, wt.to(dtype), bias, 0.1, d, res, max(rr, 1),
                          shuffle)
    want = conv3x3_plain(x, wt, bias, 0.1, d, res, max(rr, 1))
    close(got, pixel_shuffle(want, 2) if shuffle else want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("shape", [(2, 544, 960, 4), (2, 136, 240, 32),
                                   (2, 540, 960, 4), (2, 544, 960, 65)])
def test_warp_library_matches_plain(gen, dtype, mode, shape):
    """``F.grid_sample`` on the f32 grid against the exact gather on the
    warp tool's frames (in [0, 1)) and smooth flows, TOL: the normalised
    grid's round-off (~W * 2^-24 px) stays below the f32 tolerance there."""
    import numpy as np

    from video_super_resolution_tpu_torch.tools.bench_warp import (
        warp_inputs,
        warp_library,
    )

    img, flow = warp_inputs(np.random.default_rng(0), shape, 6.0,
                            torch.device("cuda"))
    img = img.to(dtype)
    close(warp_library(img, flow, mode), warp_plain(img, flow, mode), dtype)


@pytest.mark.cuda
def test_kernel_tools_on_the_card(gen):
    """The three kernel-against-library tools at tiny sizes: finite
    records within TOL of the plain versions; the A/B's kernel variant
    launches every kernel, the library one neither the conv nor the warp."""
    from video_super_resolution_tpu_torch.tools import bench_conv as bc
    from video_super_resolution_tpu_torch.tools import bench_model_ab as ab
    from video_super_resolution_tpu_torch.tools import bench_warp as bw

    for r in bc.run([(1, 24, 40, 64, 64), (2, 20, 24, 3, 32)], n=2,
                    check=True, emit=lambda s: None):
        assert r["max_abs_diff_vs_plain"] <= 2e-2 and 0 < r["peak_share"] <= 1.05
    for r in bw.run(shapes=[(2, 20, 32, 4)], n=2, check=True,
                    emit=lambda s: None):
        assert r["max_abs_diff_vs_plain"] <= 1e-4 and r["ms"] > 0
    recs = ab.run(["kernel/kernel", "library/library"], h=32, w=48, n=2,
                  reps=2, cfg=tiny_cfg("float32"), emit=lambda s: None)
    kk, ll = recs
    assert min(kk["launches"].values()) > 0
    assert ll["launches"]["conv3x3"] == ll["launches"]["warp"] == 0
    assert ll["launches"]["correlation"] == kk["launches"]["correlation"]
    assert ll["max_abs_diff_vs_first"] <= 5e-4
    assert kk["ms_per_frame"] > 0 and kk["device_ms_per_frame"] > 0


# ------------------------------------------------------- the headline bench

@pytest.mark.cuda
def test_bench_serving_on_the_card(gen):
    """``bench_serving`` at ``serving_config()`` width, 64x96: K1 / K3 / K4
    launch 59 / 4 / 4 times a forward; each chain's sum equals the same
    chain through the plain versions on the CPU, and one forward of the
    bench's model on the card equals the CPU plain forward elementwise,
    both within bf16's TOL."""
    from video_super_resolution_tpu_torch import api, bench
    from video_super_resolution_tpu_torch.tools.profile_prefix import make_window

    args = bench.parse_args(["--h", "64", "--w", "96", "--frames", "2",
                             "--warmup", "0"])
    sums = []
    rec = bench.bench_serving(args, sums=sums)
    assert rec["launches"] == {"conv3x3": 59, "correlation": 4, "warp": 4}
    assert rec["out_shape"] == [1, 256, 384, 3] and rec["device"] != "cpu"
    assert rec["value"] > 0 and rec["device_ms_per_frame"] > 0
    assert 0 < rec["busy_ms_per_frame"] and rec["idle_share"] < 1
    cfg = bench.bench_config(args)
    model = api.build_model(cfg, "cpu", seed=cfg.train.seed)
    window = make_window(cfg, 64, 96)
    want = bench.serving_chain(model, window, args.frames)
    assert len(sums) == 1 + bench.SERVING_REPS
    for s in sums:
        torch.testing.assert_close(torch.tensor(s), want,
                                   **TOL[torch.bfloat16])
    card = api.build_model(cfg, "cuda", seed=cfg.train.seed)
    close(api.upscale_window(card, window.cuda()).cpu(),
          api.upscale_window(model, window), torch.bfloat16)


# ------------------------------------------------------- the serving entry

def per_frame_route(model, frames):
    """Each frame's ``eval_step`` copied to pageable host memory on its
    own, then the clip stacked: the entry's route before pinned staging."""
    import numpy as np

    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.data.dataset import sliding_window_indices

    t = len(frames)
    return np.stack([api.eval_step(model, torch.from_numpy(frames[
        sliding_window_indices(t, c, model.cfg.window)][None]))[0].cpu().numpy()
        for c in range(t)])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 5])
def test_upscale_clip_stages_each_frame_on_the_card(gen, t):
    """``upscale_clip`` on the card equals the per-frame route bit for bit,
    in two calls of other lengths and frame sizes; the first result is its
    own array, unchanged by the second call; every frame goes through a
    pinned buffer; device memory peaks no higher than on the per-frame
    route."""
    import numpy as np

    from video_super_resolution_tpu_torch import api

    model = api.build_model(tiny_cfg(), "cuda", seed=0)
    rng = np.random.default_rng(t)
    results = []
    for n, h, w in [(t, 32, 48), (t + 1, 24, 40)]:
        frames = rng.random((n, h, w, 3), dtype=np.float32)
        per_frame_route(model, frames)               # warm: prepared weights
        torch.cuda.reset_peak_memory_stats()
        want = per_frame_route(model, frames)
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        staged = api.upscale_clip.frames_staged
        out = api.upscale_clip(model, frames)
        assert torch.cuda.max_memory_allocated() <= peak
        assert api.upscale_clip.frames_staged - staged == n
        assert out.dtype == np.float32 and out.flags.c_contiguous
        assert out.flags.owndata and out.flags.writeable
        assert np.array_equal(out, want)
        results.append((out, out.copy()))
    (first, kept), (second, _) = results
    assert not np.shares_memory(first, second) and np.array_equal(first, kept)


# ------------------------------------------- the forward from CUDA graphs

def eager_clip(model, frames):
    """Each frame's window through the model's eager forward, clamped as
    ``eval_step`` clamps: the clip without CUDA graphs."""
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.data.dataset import sliding_window_indices

    t = len(frames)
    return np.stack([api.upscale_window(model, torch.from_numpy(frames[
        sliding_window_indices(t, c, model.cfg.window)][None]))[0]
        .to(torch.float32).clamp(0.0, 1.0).cpu().numpy() for c in range(t)])


def graph_counts():
    from video_super_resolution_tpu_torch import api

    e = api.eval_step
    return e.calls, e.replays, e.captures


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["espcn", "two_stage_wf"])
def test_graphed_upscale_clip_equals_eager(gen, head):
    """``upscale_clip`` at full width, 68x120, 5 frames: the first frame
    runs eagerly, the second captures, the rest replay, and a second clip
    only replays; both clips equal the eager forward's bit for bit. The
    replayed segments run in the model's own ranges."""
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.config import serving_config
    from video_super_resolution_tpu_torch.models import graphs

    cfg = (serving_config() if head == "espcn" else serving_config(
        sr_head_style="two_stage", warp_features=True))
    model = api.build_model(cfg, "cuda", seed=0)
    frames = np.random.default_rng(5).random((5, 68, 120, 3), dtype=np.float32)
    want = eager_clip(model, frames)
    before = graph_counts()
    first = api.upscale_clip(model, frames)
    assert np.array_equal(first, want)
    assert np.subtract(graph_counts(), before).tolist() == [5, 4, 1]
    second = api.upscale_clip(model, frames)
    assert np.array_equal(second, want)
    assert np.subtract(graph_counts(), before).tolist() == [10, 9, 1]
    paths = [s.path for s in graphs.graphed(model).set.segments]
    for name in ("flow", "depth", "fd", "warp", "encode", "fusion"):
        assert (name,) in paths, name
    for name in ("sr_trunk", "sr_skip", "sr_conv"):
        assert ("sr", name) in paths, name
    assert all(p in [(), ("flow",), ("depth",), ("fd",), ("warp",),
                     ("encode",), ("fusion",), ("sr", "sr_trunk"),
                     ("sr", "sr_skip"), ("sr", "sr_conv")] for p in paths)


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["espcn", "two_stage_wf"])
def test_recycled_clip_on_the_card_equals_a_fresh_one(gen, head):
    """At full width, 68x120, 4 frames, with the recycler's floor at 0: a
    clip staged into the block of a dropped one (filled with NaN first)
    equals the fresh clip bit for bit, and ``frames_recycled`` counts its
    frames."""
    import ctypes

    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.config import serving_config
    from video_super_resolution_tpu_torch.runtime import hostmem

    cfg = (serving_config() if head == "espcn" else serving_config(
        sr_head_style="two_stage", warp_features=True))
    model = api.build_model(cfg, "cuda", seed=0)
    frames = np.random.default_rng(6).random((4, 68, 120, 3), dtype=np.float32)
    floor = ctypes.c_size_t.in_dll(hostmem.load(), "vsr_hostmem_floor")
    saved = floor.value
    hostmem.release()
    floor.value = 0
    try:
        recycled = api.upscale_clip.frames_recycled
        fresh = api.upscale_clip(model, frames)
        assert api.upscale_clip.frames_recycled == recycled
        want = fresh.copy()
        fresh.fill(np.nan)
        del fresh
        staged = api.upscale_clip.frames_staged
        again = api.upscale_clip(model, frames)
        assert api.upscale_clip.frames_recycled - recycled == 4
        assert api.upscale_clip.frames_staged - staged == 4
        assert again.flags.owndata and again.flags.writeable
        assert np.array_equal(again, want)
    finally:
        floor.value = saved
        hostmem.release()


@pytest.mark.cuda
def test_graphs_recapture_after_a_weight_update(gen):
    """An in-place weight update changes the key: the next call runs
    eagerly on the new weights, the one after captures them anew, and both
    equal the eager forward."""
    from video_super_resolution_tpu_torch import api

    model = api.build_model(tiny_cfg(), "cuda", seed=0)
    lr = torch.rand((1, 3, 24, 40, 3), generator=gen.manual_seed(1),
                    device="cuda").cpu()

    def eager():
        return api.upscale_window(model, lr).to(torch.float32).clamp(0, 1)

    for _ in range(3):
        api.eval_step(model, lr)
    with torch.no_grad():
        model.sr_head.Conv_0.weight.mul_(1.5)
    want = eager()
    c0 = graph_counts()
    out = api.eval_step(model, lr)
    assert np.subtract(graph_counts(), c0).tolist() == [1, 0, 0]
    assert torch.equal(out, want)
    out = api.eval_step(model, lr)
    assert np.subtract(graph_counts(), c0).tolist() == [2, 1, 1]
    assert torch.equal(out, want)
    assert not torch.equal(out, api.eval_step(
        api.build_model(tiny_cfg(), "cuda", seed=0), lr))


@pytest.mark.cuda
def test_a_new_shape_frees_the_old_graphs(gen):
    """A call at a new LR shape frees the live set before it runs eagerly;
    the next call at that shape captures a set for it."""
    import weakref

    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.models import graphs

    model = api.build_model(tiny_cfg(), "cuda", seed=0)
    run = graphs.graphed(model)
    a, b = torch.rand((1, 3, 24, 40, 3)), torch.rand((1, 3, 16, 48, 3))
    api.eval_step(model, a)
    api.eval_step(model, a)
    assert run.set is not None and run.set.key[0] == tuple(a.shape)
    old = weakref.ref(run.set)
    c0 = graph_counts()
    api.eval_step(model, b)
    assert old() is None and run.set is None
    assert np.subtract(graph_counts(), c0).tolist() == [1, 0, 0]
    api.eval_step(model, b)
    assert run.set.key[0] == tuple(b.shape)
    assert np.subtract(graph_counts(), c0).tolist() == [2, 1, 1]


@pytest.mark.cuda
def test_a_clip_counts_every_kernel_it_runs(gen):
    """A clip's eager, captured and replayed frames each raise the kernel
    wrappers' counters by one forward's launches: the capture counts
    nothing, each replay what its segments hold."""
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.ops.correlation import correlation
    from video_super_resolution_tpu_torch.ops.fused_conv import fused_conv3x3
    from video_super_resolution_tpu_torch.ops.warp import backward_warp

    wrappers = (fused_conv3x3, correlation, backward_warp)
    model = api.build_model(tiny_cfg(), "cuda", seed=0)
    frames = np.random.default_rng(2).random((6, 24, 40, 3), dtype=np.float32)
    before = [f.launches for f in wrappers]
    api.upscale_window(model, torch.from_numpy(frames[:3][None]))
    per_forward = [f.launches - b for f, b in zip(wrappers, before)]
    assert all(n > 0 for n in per_forward)
    before = [f.launches for f in wrappers]
    c0 = graph_counts()
    api.upscale_clip(model, frames)
    assert np.subtract(graph_counts(), c0).tolist() == [6, 5, 1]
    assert [f.launches - b for f, b in zip(wrappers, before)] == \
        [6 * n for n in per_forward]


@pytest.mark.cuda
def test_release_graphs_returns_the_pool(gen):
    """After ``release_graphs`` the device holds what it held before the
    capture; the next call at the same key runs eagerly."""
    from video_super_resolution_tpu_torch import api

    model = api.build_model(tiny_cfg(), "cuda", seed=0)
    lr = torch.rand((1, 3, 24, 40, 3))
    api.eval_step(model, lr)        # eager: prepared weights, resize tables
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    out = api.eval_step(model, lr)  # captures
    del out
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() > held
    api.release_graphs(model)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held
    c0 = graph_counts()
    api.eval_step(model, lr)
    assert np.subtract(graph_counts(), c0).tolist() == [1, 0, 0]

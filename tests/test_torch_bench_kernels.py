"""The port's kernel-against-library tools
(``video_super_resolution_tpu_torch/tools/bench_{conv,warp,model_ab}.py``)
and ``utils/profiling.roofline_report`` against the JAX repo's
``tools/bench_{conv,warp,model_ab}.py`` and ``utils/profiling.py``, on the
CPU at TINY sizes: the report's text, the two library routes against
JAX's XLA conv and exact gather warp, the warp tool's inputs against
JAX's construction, the A/B variants against JAX's model, the call
sites' restoration, each tool's record keys, and what the tools refuse.

Tolerances: the conv and warp routes against JAX in f32 rtol 1e-4, atol
1e-5 (bf16: 2e-2, one rounding of the conv and one of the output); the
warp tool's frames exact, its flow rtol 1e-5, atol 1e-5 (the same
bilinear weights in another order); the A/B variants against JAX's model
rtol 2e-3, atol 5e-4 (the composed model's tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.config import ModelConfig as JModelConfig
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel
from video_super_resolution_tpu.ops.pallas.fused_conv import _xla_conv
from video_super_resolution_tpu.ops.warp import backward_warp as jax_backward_warp
from video_super_resolution_tpu.utils.profiling import (
    roofline_report as jax_roofline_report,
)

from video_super_resolution_tpu_torch.config import ModelConfig, TrainConfig, VSRConfig
from video_super_resolution_tpu_torch.models import common, flow_net, vsr
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.ops import fused_conv
from video_super_resolution_tpu_torch.ops import warp as warp_ops
from video_super_resolution_tpu_torch.tools import bench_conv as bc
from video_super_resolution_tpu_torch.tools import bench_model_ab as ab
from video_super_resolution_tpu_torch.tools import bench_warp as bw
from video_super_resolution_tpu_torch.utils import profiling
from video_super_resolution_tpu_torch.weights import from_jax_params
from test_parallel import TINY
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
TINY_FIELDS = {f.name: getattr(TINY, f.name)
               for f in dataclasses.fields(ModelConfig)}
AB_WINDOW = (1, 3, 24, 32, 3)


def tiny_cfg() -> VSRConfig:
    return VSRConfig(model=ModelConfig(**TINY_FIELDS),
                     train=TrainConfig(compute_dtype="float32"))


def test_roofline_report_matches_jax():
    measured = {"conv3x3": (0.1342, 0.0396), "warp": (0.032, 0.0169),
                "idle": (0.0, 1.0)}
    assert profiling.roofline_report(measured) == jax_roofline_report(measured)


def test_conv3x3_roofline_counts():
    """FLOP 2 B H W Cout 9 Cin; bytes x + weight + f32 bias + out + res,
    at 989 TFLOP/s bf16 and 3.35 TB/s."""
    b, h, w, ci, co = 2, 136, 240, 243, 128     # the flow estimator's conv
    r = profiling.conv3x3_roofline_ms(b, h, w, ci, co, 2, res_bytes=1000)
    assert r["flops"] == 2 * b * h * w * co * 9 * ci
    assert r["bytes"] == (b * h * w * (ci + co) + 9 * ci * co) * 2 + co * 4 + 1000
    assert r["floor_ms"] == max(r["flops"] / 989e12, r["bytes"] / 3.35e12) * 1e3
    assert r["bound_by"] == "operations"
    f32 = profiling.conv3x3_roofline_ms(1, 544, 960, 3, 64, 4)
    assert f32["bound_by"] == "bytes" and f32["flop_ms"] == f32["flops"] / 67e12 * 1e3


# (B, H, W, Cin, Cout, dilation, res_repeat or 0 for no res, shuffle, dtype)
CONV_CASES = {
    "plain": (2, 9, 12, 8, 16, 1, 0, False, torch.float32),
    "dilation2": (1, 11, 10, 8, 8, 2, 0, False, torch.float32),
    "res_repeat2": (4, 7, 9, 6, 8, 1, 2, False, torch.float32),
    "shuffle": (1, 6, 8, 8, 16, 1, 0, True, torch.float32),
    "odd_cin": (2, 7, 9, 13, 8, 1, 0, False, torch.float32),
    "bf16": (2, 9, 12, 16, 16, 1, 1, False, torch.bfloat16),
}


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_conv3x3_library_matches_jax_xla_conv(case):
    b, h, w, ci, co, d, rr, shuffle, dt = CONV_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((co, ci, 3, 3)) / np.sqrt(9 * ci)).astype(np.float32)
    bias = (rng.standard_normal(co) * 0.1).astype(np.float32)
    res = (rng.standard_normal((b // rr, h, w, co)).astype(np.float32)
           if rr else None)
    jdt = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    want = _xla_conv(jnp.asarray(x, jdt), jnp.asarray(k.transpose(2, 3, 1, 0), jdt),
                     jnp.asarray(bias), 0.1, shuffle, d,
                     None if res is None else jnp.asarray(res), max(rr, 1))
    got = bc.conv3x3_library(
        torch.from_numpy(x).to(dt), torch.from_numpy(k).to(dt),
        torch.from_numpy(bias), 0.1, d,
        None if res is None else torch.from_numpy(res), max(rr, 1), shuffle)
    assert got.dtype == dt and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(BF16_TOL if dt == torch.bfloat16 else F32_TOL))


@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_warp_library_matches_jax_gather(mode):
    """Flows up to ~18 px on a 12x16 frame: many taps fall outside it."""
    rng = np.random.default_rng(1)
    img = rng.random((2, 12, 16, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 16, 2)) * 6).astype(np.float32)
    assert (np.abs(flow) > 8).any()
    want = jax_backward_warp(jnp.asarray(img), jnp.asarray(flow),
                             padding_mode=mode, impl="gather")
    got = bw.warp_library(torch.from_numpy(img), torch.from_numpy(flow), mode)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_bench_warp_inputs_match_jax():
    """JAX's draws (tools/bench_warp.py:89-97) from one generator over two
    shapes in turn, and its jax.image.resize of the coarse flow."""
    shapes = [(2, 16, 24, 4), (1, 20, 30, 2)]
    jrng, rng = np.random.default_rng(0), np.random.default_rng(0)
    for (b, h, w, c) in shapes:
        img = jnp.asarray(jrng.random((b, h, w, c)), jnp.float32)
        coarse = jnp.asarray(jrng.standard_normal((b, 9, 15, 2)) * 6.0
                             + jrng.standard_normal((b, 1, 1, 2)) * 3.0,
                             jnp.float32)
        flow = jax.image.resize(coarse, (b, h, w, 2), "linear")
        got_img, got_flow = bw.warp_inputs(rng, (b, h, w, c), 6.0,
                                           torch.device("cpu"))
        np.testing.assert_array_equal(got_img.numpy(), np.asarray(img))
        np.testing.assert_allclose(got_flow.numpy(), np.asarray(flow),
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ab_pair():
    """JAX's model at TINY widths (f32, the exact gather warp) with its
    initial weights, the port's model carrying them, and a window."""
    jm = JVSRModel(cfg=JModelConfig(**{**TINY_FIELDS, "warp_impl": "gather"}),
                   dtype=jnp.float32)
    x = np.random.default_rng(0).random(AB_WINDOW).astype(np.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    port = VSRModel(ModelConfig(**TINY_FIELDS))
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                         port.cfg), strict=True)
    port.eval()
    return port, torch.from_numpy(x), want


@pytest.mark.parametrize("label", ab.VARIANTS)
def test_model_ab_variant_matches_jax(ab_pair, label):
    """Each variant's forward (on the CPU the kernel sites run the plain
    versions) against JAX's model and against kernel/kernel."""
    port, x, want = ab_pair
    got = ab.variant_forward(label, port)(x)
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)
    ref = ab.variant_forward("kernel/kernel", port)(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **MODEL_TOL)


def test_library_conv_unpacks_each_weight_once(ab_pair, monkeypatch):
    port, x, _ = ab_pair
    unpacked = []

    def unpack(p):
        unpacked.append(id(p))
        return fused_conv.unpack_conv3x3_weight(p)

    monkeypatch.setattr(ab, "unpack_conv3x3_weight", unpack)
    fwd = ab.variant_forward("library/kernel", port)
    fwd(x)
    first = len(unpacked)
    fwd(x)
    assert first > 0 and len(unpacked) == first == len(set(unpacked))


def original_sites():
    return (common.fused_conv3x3, flow_net.backward_warp, vsr.backward_warp)


def test_library_sites_swap_and_restore():
    before = original_sites()
    assert before == (fused_conv.fused_conv3x3, warp_ops.backward_warp,
                      warp_ops.backward_warp)
    with ab.library_sites(True, True, {}):
        assert common.fused_conv3x3 is not before[0]
        assert flow_net.backward_warp is vsr.backward_warp is bw.warp_library
    assert original_sites() == before
    with ab.library_sites(False, True, {}):
        assert common.fused_conv3x3 is before[0]
    assert original_sites() == before


def test_library_sites_restored_after_an_exception(ab_pair):
    port, x, _ = ab_pair
    before = original_sites()
    with pytest.raises(ValueError):
        # a 2-D window fails inside the model, inside the swap
        ab.variant_forward("library/library", port)(x[0, 0, :, :, 0])
    assert original_sites() == before


def test_bench_conv_run_has_jax_keys(capsys):
    """The CLI at a tiny shape: JAX's keys, the floor, the check; the
    device line last."""
    assert bc.main(["--shapes", "1,6,8,4,8;2,5,7,3,5", "--n", "1",
                    "--check", "--device", "cpu"]) == 0
    lines = [bc.json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[-1] == {"device": "cpu"}
    assert [(r["impl"], r["shape"]) for r in lines[:-1]] == [
        ("kernel", [1, 6, 8, 4, 8]), ("library", [1, 6, 8, 4, 8]),
        ("kernel", [2, 5, 7, 3, 5]), ("library", [2, 5, 7, 3, 5])]
    for r in lines[:-1]:
        assert {"impl", "shape", "ms", "tflops", "compile_s", "floor_ms",
                "peak_share", "max_abs_diff_vs_plain"} == set(r)
        assert r["ms"] > 0 and r["peak_share"] is None
        assert r["max_abs_diff_vs_plain"] <= BF16_TOL["atol"]


def test_bench_warp_run_has_jax_keys():
    lines = []
    recs = bw.run(shapes=[(1, 8, 12, 3)], n=1, check=True, device="cpu",
                  emit=lines.append)
    assert [r["impl"] for r in recs] == list(bw.IMPLS)
    for r in recs:
        assert {"impl", "shape", "ms", "hbm_bound_ms", "compile_s", "device",
                "max_abs_diff_vs_plain"} == set(r)
        assert r["device"] == "cpu" and r["ms"] > 0
        assert r["hbm_bound_ms"] == profiling.warp_roofline_ms(1, 8, 12, 3, 4)["hbm_ms"]
        assert r["max_abs_diff_vs_plain"] <= F32_TOL["atol"]
    assert [bw.json.loads(s) for s in lines] == recs


def test_bench_model_ab_run_has_jax_keys():
    lines, outs = [], {}
    recs = ab.run(h=16, w=24, n=2, reps=2, device="cpu", cfg=tiny_cfg(),
                  emit=lines.append, outputs=outs)
    assert set(ab.json.loads(lines[0])) == {"pull_ms"}
    assert [r["variant"] for r in recs] == list(ab.VARIANTS) == list(outs)
    for r in recs:
        assert {"variant", "ms_per_frame", "std_ms", "fps", "median_ms",
                "min_ms", "device_ms_per_frame", "compile_s",
                "timed_forwards", "launches", "max_abs_diff_vs_first"} == set(r)
        assert r["ms_per_frame"] > 0 and r["device_ms_per_frame"] is None
        assert r["timed_forwards"] == 4
        # the CPU runs the plain versions: no kernel launches
        assert r["launches"] == {"conv3x3": 0, "correlation": 0, "warp": 0}
        assert r["max_abs_diff_vs_first"] <= MODEL_TOL["atol"]
        assert tuple(outs[r["variant"]].shape) == (1, 64, 96, 3)


@pytest.mark.parametrize("label,token", [
    ("kernel/kernel/kcat", "kcat"), ("library/kernel/noppack", "noppack"),
    ("kernel/library/vmem8", "vmem8"), ("kernel/kernel/th16", "th16"),
    ("kernel/kernel/encpack", "encpack")])
def test_bench_model_ab_refuses_jax_tokens(label, token):
    with pytest.raises(ValueError, match=f"'{token}' switches a TPU layout"):
        ab.run([label], device="cpu")


@pytest.mark.parametrize("label", ["xla/pallas", "kernel", "kernel/gather"])
def test_bench_model_ab_refuses_jax_impls(label):
    with pytest.raises(ValueError, match="is not conv/warp"):
        ab.parse_variant(label)


def test_bench_model_ab_refuses_stages():
    with pytest.raises(ValueError, match="tools/profile_prefix.py"):
        ab.main(["--stages", "flow,full", "--device", "cpu"])


@pytest.mark.parametrize("tool", ["bench_conv", "bench_warp", "bench_model_ab"])
def test_tools_raise_on_cuda_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"bench_conv": bc, "bench_warp": bw, "bench_model_ab": ab}[tool]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])

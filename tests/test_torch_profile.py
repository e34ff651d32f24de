"""The port's profile tools (``video_super_resolution_tpu_torch/tools/
profile_model.py`` and ``profile_prefix.py``) on the CPU at small sizes:

- each ``profile_model`` stage against the JAX stage it is named after
  (the JAX tool's ``tools/profile_model.py:139-200``, built here as that
  tool builds it), on the same inputs and weights: rtol 1e-4 / atol 1e-5
  per module, 2e-3 / 2e-4 for the flow net, 2e-3 / 5e-4 for the composed
  model (the repo's torch-oracle tolerances);
- both tools' ``main`` print a line for every stage name;
- the prefix lines are cumulative and their deltas sum to the last;
- the attribution of device work to ranges, on a synthetic trace;
- the model's stage ranges leave its output bit-equal.
"""

import contextlib
import json
import types

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu import config as jconfig
from video_super_resolution_tpu.models.common import ConvLReLU as JConvLReLU
from video_super_resolution_tpu.models.depth_net import DepthNet as JDepthNet
from video_super_resolution_tpu.models.flow_net import FlowNet as JFlowNet
from video_super_resolution_tpu.models.fusion import DepthGuidedFusion as JFusion
from video_super_resolution_tpu.models.sr_head import SRHead as JSRHead
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel
from video_super_resolution_tpu.ops.correlation import correlation as jcorrelation
from video_super_resolution_tpu.ops.resize import resize_bilinear as jresize
from video_super_resolution_tpu.ops.warp import backward_warp as jwarp

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import ModelConfig, TrainConfig, VSRConfig
from video_super_resolution_tpu_torch.models import sr_head, vsr
from video_super_resolution_tpu_torch.tools import profile_model as pm
from video_super_resolution_tpu_torch.tools import profile_prefix as pp
from video_super_resolution_tpu_torch.weights import to_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

SMALL = dict(pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
             context_channels=(16, 16), depth_channels=8, depth_levels=2,
             fusion_channels=16, sr_channels=16, sr_blocks=2,
             warp_impl="gather")
H, W = 18, 26                # padded to 20x28 by the model and the tool
MODULE_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = {"full_model": dict(rtol=2e-3, atol=5e-4),
       "flow_net(2 nbrs)": dict(rtol=2e-3, atol=2e-4)}


def small_cfg(**model_kw):
    return VSRConfig(model=ModelConfig(**SMALL, **model_kw),
                     train=TrainConfig(compute_dtype="float32"))


def jax_stages(mc, p, hp, wp):
    """The JAX tool's stage functions (``tools/profile_model.py:139-200``),
    its modules built as the JAX model builds them."""
    dt = jnp.float32
    flow_mod = JFlowNet(mc.pyramid_channels, mc.flow_estimator_channels,
                        mc.context_channels, mc.max_displacement,
                        mc.lrelu_slope, False, dt,
                        finest_level=mc.flow_finest_level,
                        warp_impl=mc.warp_impl)
    depth_mod = JDepthNet(mc.depth_channels, mc.depth_levels, mc.lrelu_slope,
                          False, dtype=dt)
    fusion_mod = JFusion(mc.fusion_channels, mc.lrelu_slope, False, dt)
    sr_mod = JSRHead(features=mc.sr_channels, blocks=mc.sr_blocks,
                     scale=mc.scale, slope=mc.lrelu_slope,
                     wide_blocks=mc.sr_wide_blocks, style=mc.sr_head_style,
                     use_pallas=False, dtype=dt)

    class Enc(fnn.Module):
        @fnn.compact
        def __call__(self, z):
            z = JConvLReLU(mc.fusion_channels, slope=mc.lrelu_slope, dtype=dt,
                           name="frame_encoder_0")(z)
            return JConvLReLU(mc.fusion_channels, slope=mc.lrelu_slope,
                              dtype=dt, name="frame_encoder_1")(z)

    enc = {"frame_encoder_0": p["frame_encoder_0"],
           "frame_encoder_1": p["frame_encoder_1"]}
    return {
        "full_model": lambda wdw: JVSRModel(cfg=mc, dtype=dt).apply(
            {"params": p}, wdw),
        "flow_net(2 nbrs)": lambda a, b: flow_mod.apply(
            {"params": p["flow_net"]}, a, b),
        "depth_net(T frames, half-res)": lambda f: jresize(depth_mod.apply(
            {"params": p["depth_net"]}, jresize(f, hp // 2, wp // 2)), hp, wp),
        "warp_full(4ch x nbrs)": lambda f, fl: jwarp(
            f, fl, use_pallas=False, impl=mc.warp_impl),
        "encoder(T frames)": lambda x: Enc().apply({"params": enc}, x),
        "fusion": lambda a, b, c, d: fusion_mod.apply(
            {"params": p["fusion"]}, a, b, c, d),
        "sr_head": lambda f, r: sr_mod.apply({"params": p["sr_head"]}, f, r),
        "corr_level0(16ch, 1/2res)": lambda a, b: jcorrelation(
            a, b, mc.max_displacement, use_pallas=False),
        "resize_skip(3ch x4)": lambda r: jresize(r, H * 4, W * 4),
    }


@pytest.fixture(scope="module")
def stage_pairs():
    """{stage: (port output, JAX output)} on the tool's inputs."""
    cfg = small_cfg()
    model = api.build_model(cfg, "cpu", seed=0)
    x = pm.make_inputs(model, H, W)
    hp, wp = x["frames"].shape[1:3]
    js = jax_stages(jconfig.ModelConfig(**SMALL),
                    to_jax_params(model.state_dict()), hp, wp)
    out = {}
    with torch.no_grad():
        for name, fn, args in pm.stages(model, x, H, W):
            got = fn(*args)
            want = js[name](*[jnp.asarray(a.numpy()) for a in args])
            out[name] = (got.numpy(), np.asarray(want))
    return out


@pytest.mark.parametrize("stage", pm.JAX_STAGES[:-1])
def test_profile_model_stage_matches_jax(stage_pairs, stage):
    got, want = stage_pairs[stage]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL.get(stage, MODULE_TOL))


def test_profile_model_inputs_follow_the_jax_tool():
    """The JAX tool's draws (window, then f16 .. frames4, from
    default_rng(0)) and shapes, with the model's padding."""
    model = api.build_model(small_cfg(), "cpu", seed=0)
    x = pm.make_inputs(model, H, W)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        x["window"].numpy(), rng.random((1, 3, H, W, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        x["f16"].numpy(), rng.random((2, 10, 14, 16)).astype(np.float32))
    assert x["frames"].shape == (3, 20, 28, 3) and x["flows"].shape == (2, 20, 28, 2)
    assert x["frames4"].shape == (2, 20, 28, 4)
    np.testing.assert_array_equal(x["ref"][0, :H, :W].numpy(),
                                  x["window"][0, 1].numpy())


def _lines(capsys, key):
    return [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")
            and key in line]


@pytest.mark.parametrize("tool", ["profile_model", "profile_prefix"])
def test_main_prints_every_stage(capsys, tool):
    """``VSRConfig()`` at 32x64, bf16, the plain versions on the CPU."""
    mod = pm if tool == "profile_model" else pp
    assert mod.main(["--h", "32", "--w", "64", "--n", "1",
                     "--device", "cpu"]) == 0
    if tool == "profile_model":
        lines = _lines(capsys, '"stage"')
        assert [r["stage"] for r in lines] == list(pm.JAX_STAGES)
        for r in lines[:-1]:
            assert r["ms"] > 0 and r["host_ms"] > 0, r
        assert lines[-1]["device"].startswith("cpu")
        return
    lines = _lines(capsys, '"prefix"')
    names = [r["prefix"] for r in lines]
    assert names == list(pp.STAGES) + ["glue", "full"]
    assert set(pp.JAX_PREFIXES) <= set(names)
    assert lines[-1]["attribution"] == "cpu-ops"


def test_prefix_lines_are_cumulative():
    lines = pp.run(h=H, w=W, n=2, device="cpu", cfg=small_cfg(),
                   emit=lambda s: None)
    ms = [r["ms"] for r in lines]
    assert all(b >= a - 1e-9 * ms[-1] for a, b in zip(ms, ms[1:]))
    np.testing.assert_allclose(sum(r["delta_ms"] for r in lines), ms[-1],
                               rtol=1e-9)
    assert all(r["delta_ms"] > 0 for r in lines[:-2])
    assert abs(lines[-1]["delta_ms"]) <= 1e-9 * ms[-1]
    assert lines[-1]["unattributed_ms"] == 0
    # a stage left out counts in the next line printed
    some = pp.run(h=H, w=W, n=2, device="cpu", cfg=small_cfg(),
                  stages=["depth", "warp", "sr_conv"], emit=lambda s: None)
    assert [r["prefix"] for r in some] == ["depth", "warp", "sr_conv", "glue", "full"]
    with pytest.raises(ValueError, match="no stage"):
        pp.run(h=H, w=W, n=1, device="cpu", cfg=small_cfg(),
               stages=["sr_up"], emit=lambda s: None)


def _ev(name, start, end, device="cpu", id=0, annotation=False):
    dt = torch.autograd.DeviceType.CUDA if device == "cuda" else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=name, id=id, device_type=dt, is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end), cpu_parent=None)


class _Raw:
    """A profiler raw (kineto) event over an ``_ev`` (ns from the trace's
    start)."""

    def __init__(self, e):
        self._e = e

    def name(self):
        return self._e.name

    def correlation_id(self):
        return self._e.id

    def device_type(self):
        return self._e.device_type

    def start_ns(self):
        return self._e.time_range.start * 1000

    def end_ns(self):
        return self._e.time_range.end * 1000

    def is_user_annotation(self):
        return self._e.is_user_annotation


class _Trace:
    def __init__(self, events):
        self._events = events
        raw = [_Raw(e) for e in events]
        self.profiler = types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(
                trace_start_ns=lambda: 0, events=lambda: raw))

    def events(self):
        return self._events


def test_attribution_of_device_work():
    """Kernels go to the innermost host range that held their launch (the
    same correlation id); the outer "sr" range and the space outside the
    ranges are glue; a kernel with no launch is unattributed. The
    device-side spans give the same split, and a difference shows."""
    ev = [
        _ev(pp.CALL, 0, 100, annotation=True),
        _ev("flow", 10, 30, annotation=True),
        _ev("sr", 40, 90, annotation=True),
        _ev("sr_trunk", 45, 60, annotation=True),
        _ev("sr_conv", 70, 80, annotation=True),
        _ev("aten::cat", 5, 8), _ev("cudaLaunchKernel", 6, 7, id=1),
        _ev("cudaLaunchKernel", 12, 13, id=2),
        _ev("cuLaunchKernelEx", 50, 51, id=3),
        _ev("cudaLaunchKernel", 62, 63, id=4),
        _ev("cudaLaunchKernel", 72, 73, id=5),
        _ev("k_glue", 200, 210, "cuda", id=1),
        _ev("k_flow", 215, 245, "cuda", id=2),
        _ev("flow", 215, 245, "cuda", annotation=True),
        _ev("k_trunk", 250, 290, "cuda", id=3),
        _ev("sr_trunk", 250, 290, "cuda", annotation=True),
        _ev("k_sr", 290, 292, "cuda", id=4),
        _ev("k_conv", 292, 300, "cuda", id=5),
        _ev("sr_conv", 292, 300, "cuda", annotation=True),
        _ev("memcpy", 300, 305, "cuda", id=99),
    ]
    a = pp.attribute(_Trace(ev), on_device=True)
    assert a["attribution"] == "launch" and a["order"] == ["flow", "sr_trunk", "sr_conv"]
    assert dict(a["work_us"]) == {"glue": 12, "flow": 30, "sr_trunk": 40, "sr_conv": 8}
    assert a["unattributed_us"] == 5 and a["total_us"] == 95
    assert a["span_diff_us"] == 0
    assert a["host_us"]["sr_trunk"] == 15 and a["host_us"][pp.CALL] == 100
    lines = pp.prefix_lines(a, n=1)
    assert [r["prefix"] for r in lines] == ["flow", "sr_trunk", "sr_conv", "glue", "full"]
    assert [r["delta_ms"] * 1e3 for r in lines] == pytest.approx([30, 40, 8, 12, 5])
    assert lines[3]["host_ms"] * 1e3 == pytest.approx(100 - 20 - 15 - 10)
    assert pp.device_spans(_Trace(ev)) == {"flow": 30, "sr_trunk": 40, "sr_conv": 8}
    # a kernel attributed against the device-side spans elsewhere shows
    ev[15] = _ev("sr_trunk", 250, 291, "cuda", annotation=True)
    assert pp.attribute(_Trace(ev), on_device=True)["span_diff_us"] == 2
    # no launch events: nothing is attributed, and the full line says so
    b = pp.attribute(_Trace([e for e in ev if not e.name.startswith("cu")]),
                     on_device=True)
    assert b["unattributed_us"] == b["total_us"] == 95 and not b["work_us"]
    assert pp.prefix_lines(b, n=1)[-1]["delta_ms"] * 1e3 == pytest.approx(95)


def test_short_trace_raises():
    """A trace that holds fewer runs of a port kernel than its wrapper
    counted launches raises, naming the kernel; runs beyond the count
    (a kernel launched outside the wrappers) and other kernels do not."""
    ev = [_ev("void conv3x3_kernel<__nv_bfloat16, 128, 64, 64>(...)", 0, 5,
              "cuda"),
          _ev("void conv3x3_stage_kernel<float>(...)", 5, 6, "cuda"),
          _ev("void warp_pair_kernel<float>(...)", 6, 8, "cuda"),
          _ev("void warp_kernel<float>(...)", 8, 9, "cuda"),
          _ev("ampere_sgemm", 9, 12, "cuda")]
    pp.check_traced(_Trace(ev), {"conv3x3": 1, "correlation": 0, "warp": 2})
    pp.check_traced(_Trace(ev), {"conv3x3": 0, "warp": 1})
    with pytest.raises(pp.ShortTrace, match="conv3x3.*traced': 1, "
                       "'launched': 2"):
        pp.check_traced(_Trace(ev), {"conv3x3": 2, "warp": 2})
    with pytest.raises(RuntimeError, match="correlation"):
        pp.check_traced(_Trace(ev), {"correlation": 1})


def test_short_trace_is_taken_again(monkeypatch):
    """On a card ``profiled`` takes a trace again while it lacks a counted
    launch, with the next of LEADS, warning each time, and raises after
    TRACES short ones."""
    full = _Trace([_ev("void warp_kernel<float>(...)", 0, 2, "cuda")])
    empty = _Trace([])
    traces, leads = [], []

    def fake(fn, n, dev, lead):
        leads.append(lead)
        return traces.pop(0), {"warp": 1}
    monkeypatch.setattr(pp, "trace_once", fake)
    card = torch.device("cuda")
    traces[:] = [empty, full, empty]
    with pytest.warns(UserWarning,
                      match=f"tracing again with a {pp.LEADS[1]} s lead"):
        assert pp.profiled(lambda: None, 1, card) is full
    assert traces == [empty] and leads == list(pp.LEADS[:2])
    traces[:], leads[:] = [empty] * pp.TRACES, []
    with pytest.warns(UserWarning), pytest.raises(pp.ShortTrace):
        pp.profiled(lambda: None, 1, card)
    assert traces == [] and leads == list(pp.LEADS)
    assert pp.LEADS[0] > 0 and list(pp.LEADS) == sorted(pp.LEADS)


def test_spin_kernels_are_not_device_work():
    """The spin kernels that lead a trace on the card are no device event
    of it."""
    ev = [_ev("spin_kernel(long)", 0, 500, "cuda", id=1),
          _ev("void warp_kernel<float>(...)", 600, 602, "cuda", id=2)]
    assert [e.name for e in pp.device_events(_Trace(ev))] == [ev[1].name]


def test_short_trace_names_the_lost_launches():
    """A short trace says which host launches lack their kernel (same
    correlation id): their place among the launches and their time, and
    when the first launch and the first device event came."""
    ev = [_ev("cudaLaunchKernel", 10, 11, id=1),
          _ev("cuLaunchKernelEx", 12, 13, id=2),
          _ev("cudaLaunchKernel", 14, 15, id=3),
          _ev("cudaDeviceSynchronize", 16, 30),
          _ev("void conv3x3_kernel<float>(...)", 20, 22, "cuda", id=2),
          _ev("void warp_kernel<float>(...)", 22, 25, "cuda", id=3)]
    where = pp.lost_launches(_Trace(ev))
    assert where == {"launches": 3, "lost": [(0, 10.0)],
                     "first_device_us": 20.0, "first_launch_us": 10.0}
    with pytest.raises(pp.ShortTrace, match=r"'lost': \[\(0, 10.0\)\]"):
        pp.check_traced(_Trace(ev), {"conv3x3": 2})
    pp.check_traced(_Trace(ev), {"conv3x3": 1, "warp": 1})


@pytest.mark.parametrize("argv", [["--one", "--traces", "1"],
                                  ["--one", "--traces", "1", "--lead", "0"]])
def test_trace_check_needs_the_card(monkeypatch, argv):
    from video_super_resolution_tpu_torch.tools import trace_check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_check.main(argv)


@contextlib.contextmanager
def _no_ranges():
    saved = vsr.stage, sr_head.stage
    vsr.stage = sr_head.stage = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        vsr.stage, sr_head.stage = saved


@pytest.mark.parametrize("layout", [{}, dict(warp_features=True,
                                             sr_head_style="two_stage")])
def test_stage_ranges_leave_the_forward_bit_equal(layout):
    cfg = small_cfg(**layout)
    model = api.build_model(cfg, "cpu", seed=0)
    window = pp.make_window(cfg, H, W)
    got = api.upscale_window(model, window)
    with _no_ranges():
        want = api.upscale_window(model, window)
    assert torch.equal(got, want)

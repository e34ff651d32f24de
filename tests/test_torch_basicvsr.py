"""BasicVSR on the port (``models/basicvsr.py``) against its plain
reference (``reference/basicvsr.py``, BasicSR's equations in plain f32
PyTorch) on the CPU, at the same seeded weights: SPyNet alone, one trunk
step, and whole clips through ``api.upscale_clip``; a planted fault fails
the comparison; the init factors are BasicSR's rule; the benchmark's frozen
copy of the reference agrees with the port's to the bit; the benchmark's
check reads the flows the served route was given.

Tiny trunks (8 features, 2 blocks) but SPyNet at its published widths.
LR sides must be above 32 (five halvings of a 32-multiple leave at least
two pixels, and BasicSR's starting flow half of that): 48x64, 5-frame
clips.
"""

import functools
import math

import numpy as np
import pytest
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import BasicVSRConfig
from video_super_resolution_tpu_torch.models.basicvsr import BasicVSR
from video_super_resolution_tpu_torch.reference import basicvsr as reference
from vsr_bench import run as bench
from vsr_bench import weights
from vsr_bench.reference import basicvsr as frozen
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

M = {"num_feat": 8, "num_block": 2}
CFG = BasicVSRConfig(compute_dtype="float32", **M)
SEED = 2 ** 31 + 5
H, W, T = 48, 64, 5
# the composed model's tolerances (tests/test_module_oracles_full.py): the
# port and the reference sum in other orders through SPyNet's six levels,
# two recurrences of T steps and the upsampler, and the warp's taps come
# from the pixel offset where grid_sample's come from normalised
# coordinates
RTOL, ATOL = 2e-3, 5e-4


def seeded_weights(seed=SEED):
    """The benchmark's draw, scaled by BasicSR's init."""
    w = weights.make(reference.param_shapes(M), seed, torch.device("cpu"))
    for name, factor in reference.init_scale(M).items():
        w[name].mul_(factor)
    return w


@pytest.fixture(scope="module")
def model_and_weights():
    w = seeded_weights()
    model = api.build_model(CFG, "cpu")
    weights.load(model, w)
    return model, w


def clip(seed=0, t=T):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(t, H, W, 3, generator=gen)


def test_parameter_tree_is_basicsrs(model_and_weights):
    model, _ = model_and_weights
    assert isinstance(model, BasicVSR)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == \
        reference.param_shapes(M)
    assert "spynet.basic_module.5.basic_module.8.weight" in dict(
        model.named_parameters())


def test_spynet_matches_reference(model_and_weights):
    model, w = model_and_weights
    x = clip(1)
    ref, supp = x[:-1], x[1:]
    with torch.no_grad():
        got = model.spynet(ref, supp)
        want = reference.spynet(w, reference.Ops(), ref.permute(0, 3, 1, 2),
                                supp.permute(0, 3, 1, 2))
    assert got.shape == (T - 1, H, W, 2)
    # the flow net's tolerances (tests/test_module_oracles_full.py)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=2e-3, atol=2e-4)
    assert float(want.abs().max()) > 1e-3        # the flows are not all 0


@pytest.mark.parametrize("trunk", ["backward_trunk", "forward_trunk"])
def test_one_trunk_step_matches_reference(model_and_weights, trunk):
    model, w = model_and_weights
    gen = torch.Generator().manual_seed(2)
    frame = torch.rand(1, H, W, 3, generator=gen)
    state = torch.randn(1, H, W, M["num_feat"], generator=gen) * 0.1
    flow = torch.randn(1, H, W, 2, generator=gen) * 3.0
    with torch.no_grad():
        got = model.step(getattr(model, trunk), frame, state, flow)
        want = reference.step(w, M, reference.Ops(), trunk,
                              frame.permute(0, 3, 1, 2),
                              state.permute(0, 3, 1, 2),
                              flow.permute(0, 3, 1, 2))
    # per module (tests/test_module_oracles_full.py)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=1e-5)


def upscale_gap(model, w, x):
    """The port's served clip and the reference's clipped as it clips."""
    out = api.upscale_clip(model, x.numpy())
    with torch.no_grad():
        want = reference.forward(w, M, x).clamp(0.0, 1.0).numpy()
    return out, want


@pytest.mark.parametrize("t", [1, T])
def test_whole_clip_matches_reference(model_and_weights, t):
    model, w = model_and_weights
    clips, held = api.upscale_clip.whole_clips, api.upscale_clip.state_bytes
    out, want = upscale_gap(model, w, clip(3, t))
    assert out.shape == (t, 4 * H, 4 * W, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
    assert api.upscale_clip.whole_clips == clips + 1
    assert api.upscale_clip.state_bytes - held == t * H * W * M["num_feat"] * 4


class _ZeroState(torch.nn.Module):
    """A trunk whose input state is zeroed: the backward state reset at
    every frame."""

    def __init__(self, trunk):
        super().__init__()
        self.trunk = trunk

    def forward(self, x):
        return self.trunk(torch.cat([x[..., :3], torch.zeros_like(x[..., 3:])],
                                    dim=-1))


def test_reset_backward_state_fails_the_comparison(model_and_weights):
    model, w = model_and_weights
    x = clip(3)
    trunk = model.backward_trunk
    model.backward_trunk = _ZeroState(trunk)
    try:
        out, want = upscale_gap(model, w, x)
    finally:
        model.backward_trunk = trunk
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)
    # the last frame has no backward history: the fault leaves it as it was
    np.testing.assert_allclose(out[-1], want[-1], rtol=RTOL, atol=ATOL)


def test_init_scale_is_basicsrs_rule():
    """Each factor times the harness's LeCun std 1 / sqrt(fan_in) is the
    std of BasicSR's init: Kaiming normal x 0.1 for the residual blocks'
    convs, ``nn.Conv2d``'s default elsewhere (measured on large draws)."""
    factors = reference.init_scale(M)
    shapes = reference.param_shapes(M)
    assert set(factors) == {n for n, s in shapes.items() if len(s) == 4}
    gen = torch.Generator().manual_seed(0)
    block = torch.empty(256, 256, 3, 3)
    torch.nn.init.kaiming_normal_(block, generator=gen)
    block *= 0.1
    other = torch.empty(256, 256, 3, 3)
    torch.nn.init.kaiming_uniform_(other, a=math.sqrt(5), generator=gen)
    lecun = 1.0 / math.sqrt(256 * 9)
    for name, factor in factors.items():
        want = block if ".main.2." in name else other
        assert factor * lecun == pytest.approx(float(want.std()), rel=0.01), \
            name
        if ".main.2." in name:
            assert name.endswith((".conv1.weight", ".conv2.weight"))


def test_reference_copies_agree_bit_for_bit():
    w = seeded_weights(SEED + 1)
    x = clip(4)
    with torch.no_grad():
        a = reference.forward(w, M, x)
        b = frozen.forward(w, M, x)
    assert torch.equal(a, b)
    assert reference.param_shapes(M) == frozen.param_shapes(M)
    assert reference.init_scale(M) == frozen.init_scale(M)


def test_small_frames_are_refused(model_and_weights):
    model, _ = model_and_weights
    with pytest.raises(ValueError, match="above 32"):
        model.spynet(torch.rand(1, 32, 64, 3), torch.rand(1, 32, 64, 3))


def bench_run(fault=None):
    """A tiny run of the benchmark's BasicVSR cell on the CPU."""
    return bench.run_cell(
        "basicvsr.wholeclip.540p", SEED, 0.2, False, device="cpu",
        config_overrides={"model": M, "train": {"compute_dtype": "float32"}},
        traffic_overrides={"lr_h": H, "lr_w": W, "clip_frames": [3, 4],
                           "pool_clips": 2, "check_clips": 2},
        fault=fault)


def test_benchmark_reads_the_flows_the_route_was_given():
    out = bench_run()
    assert out["correct"], out["checks"]
    assert out["checks"]["flow_rms"]["value"] < 1e-5
    assert len(out["detail"]["flow_by_clip"]) == min(out["attempted"], 2)


def test_benchmark_fails_zeroed_flows_by_the_flow_check():
    checks = bench_run("zero_flow")["checks"]
    for name in ("flow_rms", "flow_max"):
        assert checks[name]["value"] > checks[name]["limit"], checks


def test_benchmark_fails_a_route_that_takes_no_flows(monkeypatch):
    """A route that estimates its flows other than through ``model.flows``
    gives the check no flows to read: NaN, which fails."""
    frames = BasicVSR.frames

    def bypass(self, clip):
        self.flows = functools.partial(BasicVSR.flows, self)
        return frames(self, clip)

    monkeypatch.setattr(BasicVSR, "frames", bypass)
    out = bench_run()
    assert not out["correct"]
    assert out["checks"]["flow_rms"]["value"] == "nan"

"""The port's debug and profiling helpers (``utils/debug.py``,
``utils/profiling.py``) against the JAX package's: the non-finite finder
over the same tensors, ``checked_apply`` raising where ``checkify``'s
float checks do (and naming the module), the roofline figures of the
H100, and a CPU trace with the model's stage ranges."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.models import common as jc
from video_super_resolution_tpu.utils import debug as jdebug

from video_super_resolution_tpu_torch.config import ModelConfig
from video_super_resolution_tpu_torch.models import common as pc
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.utils import debug, profiling
from video_super_resolution_tpu_torch.weights import from_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker


def test_find_nonfinite_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((4, 5)).astype(np.float32),
                  "b": rng.standard_normal(3).astype(np.float32)},
            "c": rng.standard_normal((2, 2)).astype(np.float32),
            "n": np.arange(4)}
    tree["a"]["w"][1, 2] = np.nan
    tree["a"]["w"][3, 0] = np.inf
    tree["c"][:] = -np.inf
    want = jdebug.find_nonfinite(tree)
    got = debug.find_nonfinite(
        {"a": {k: torch.from_numpy(v) for k, v in tree["a"].items()},
         "c": torch.from_numpy(tree["c"]), "n": torch.from_numpy(tree["n"])})
    assert got == {"a.w": (1, 1), "c": (0, 4)}
    assert sorted(want.values()) == sorted(got.values())
    assert debug.find_nonfinite({"x": torch.ones(3)}) == {}


@pytest.mark.parametrize("poison", [None, "inf_weight", "nan_input"])
def test_checked_apply_raises_where_checkify_does(poison):
    """A ConvLReLU: finite in, finite out for both; weights of +inf and
    -inf on two input channels make the conv produce NaN (inf - inf), a
    NaN input spreads to the output: checkify raises, and the port names
    the module."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 6, 7, 8)).astype(np.float32)
    jm = jc.ConvLReLU(4)
    params = jax.tree.map(np.array, jm.init(jax.random.key(0),
                                              jnp.asarray(x))["params"])
    if poison == "inf_weight":
        params["kernel"][1, 1, 0, 2] = np.inf
        params["kernel"][1, 1, 1, 2] = -np.inf
    if poison == "nan_input":
        x[0, 3, 3, 1] = np.nan
    port = pc.ConvLReLU(8, 4)
    port.load_state_dict(from_jax_params(params, port))
    run_j = jdebug.checked_apply(jm.apply)
    run_p = debug.checked_apply(port)
    if poison is None:
        want = np.asarray(run_j({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = run_p(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        return
    with pytest.raises(Exception, match="nan generated"):
        run_j({"params": params}, jnp.asarray(x))
    with pytest.raises(debug.NonFiniteError, match="ConvLReLU"):
        with torch.no_grad():
            run_p(torch.from_numpy(x))
    assert not port._forward_hooks           # the hooks are removed


def test_checked_apply_names_the_first_bad_submodule():
    model = VSRModel(ModelConfig(pyramid_channels=(8, 16),
                                 flow_estimator_channels=(16, 16),
                                 context_channels=(16, 16), depth_channels=8,
                                 depth_levels=2, fusion_channels=16,
                                 sr_channels=16, sr_blocks=2))
    with torch.no_grad():
        model.sr_head.Conv_0.bias[3] = float("nan")
    x = torch.rand((1, 3, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    with pytest.raises(debug.NonFiniteError, match="sr_head.Conv_0 "):
        with torch.no_grad():
            debug.checked_apply(model)(x)


def test_rooflines_use_h100_figures():
    c = profiling.correlation_roofline_ms(1, 136, 240, 32, 4, 2, 2)
    assert c["bytes"] == 2 * 136 * 240 * 32 * 2 + 136 * 240 * 81 * 2
    assert c["flops"] == 2 * 136 * 240 * 32 * 81
    assert c["hbm_ms"] == pytest.approx(c["bytes"] / 3.35e12 * 1e3)
    assert c["flop_ms"] == pytest.approx(c["flops"] / 989e12 * 1e3)
    assert c["floor_ms"] == max(c["hbm_ms"], c["flop_ms"])
    w = profiling.warp_roofline_ms(2, 544, 960, 65, 2)
    # the 65-channel feature warp at 540x960 (padded to 544), bf16
    assert w["bytes"] == 2 * 2 * 544 * 960 * 65 * 2 + 2 * 544 * 960 * 8
    assert w["bound_by"] == "bytes"
    assert w["floor_ms"] == pytest.approx(0.0836, abs=1e-4)
    f32 = profiling.correlation_roofline_ms(1, 8, 8, 16, 1)
    assert f32["flop_ms"] == pytest.approx(f32["flops"] / 67e12 * 1e3)


def test_profile_trace_writes_stage_ranges(tmp_path):
    model = VSRModel(ModelConfig(pyramid_channels=(8, 16),
                                 flow_estimator_channels=(16, 16),
                                 context_channels=(16, 16), depth_channels=8,
                                 depth_levels=2, fusion_channels=16,
                                 sr_channels=16, sr_blocks=2,
                                 warp_features=True))
    x = torch.rand((1, 3, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    with profiling.profile_trace(str(tmp_path)) as prof:
        with torch.no_grad():
            model(x)
    names = {e.key for e in prof.key_averages()}
    assert {"flow", "depth", "warp", "encode", "fusion", "sr"} <= names
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(ev.get("name") == "warp" for ev in trace["traceEvents"])

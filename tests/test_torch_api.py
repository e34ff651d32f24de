"""The PyTorch port's boundaries: what it imports, where its entry points
run, and how weights cross from the JAX package's flax param tree."""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.config import serving_config as jax_serving_config
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig, serving_config
from video_super_resolution_tpu_torch.models.common import init_params
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.weights import from_jax_params, to_jax_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "video_super_resolution_tpu_torch").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "video_super_resolution_tpu"}


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_jax_package(path):
    """Matches the top-level module name exactly, so the port's own name
    (which starts with the JAX package's) is allowed."""
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_build_model_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build_model(serving_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        api.build_flow_net(serving_config())


def test_build_model_on_cpu_is_seeded():
    a = api.build_model(serving_config(), device="cpu", seed=5)
    b = api.build_model(serving_config(), device="cpu", seed=5)
    c = api.build_model(serving_config(), device="cpu", seed=6)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["sr_head.subpixel_conv.weight"],
                           sc["sr_head.subpixel_conv.weight"])


def test_unknown_sr_head_style_raises():
    with pytest.raises(ValueError, match="sr_head_style"):
        VSRModel(dataclasses.replace(serving_config().model,
                                     sr_head_style="pixelshuffle"))


def test_config_json_round_trip_matches_jax_package():
    """The port's config copy serializes field-for-field like the JAX one."""
    js = jax_serving_config().to_json()
    assert serving_config().to_json() == js
    assert VSRConfig.from_json(js) == serving_config()


def test_estimate_and_align_on_cpu():
    net = api.build_flow_net(serving_config(), device="cpu", seed=0)
    g = torch.Generator().manual_seed(0)
    ref = torch.rand((1, 20, 36, 3), generator=g)
    nbrs = torch.rand((1, 2, 20, 36, 3), generator=g)
    flows, warped = api.estimate_and_align(net, ref, nbrs, "border")
    assert tuple(flows.shape) == (1, 2, 20, 36, 2)
    assert tuple(warped.shape) == (1, 2, 20, 36, 3)
    assert bool(torch.isfinite(flows).all() and torch.isfinite(warped).all())


# ---------------------------------------------------------------- weights

@pytest.fixture(scope="module")
def serving_tree():
    """Shapes of the JAX serving model's param tree (traced, not run),
    filled with distinct random values."""
    cfg = jax_serving_config()
    jm = JVSRModel(cfg=cfg.model, dtype=jnp.float32)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, 3, 64, 64, 3), jnp.float32))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes["params"])


def _leaf(tree, *path):
    for p in path:
        tree = tree[p]
    return tree


def test_weight_bridge_strict_load_and_round_trip(serving_tree):
    sd = from_jax_params(serving_tree, serving_config())
    model = VSRModel(serving_config().model)
    model.load_state_dict(sd, strict=True)
    back = to_jax_params(model.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(serving_tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_weight_bridge_maps_by_name_not_order(serving_tree):
    """flax sorts ConvLReLU_10 before ConvLReLU_2; each must land on the
    port conv of the same name (HWIO -> OIHW)."""
    sd = from_jax_params(serving_tree, serving_config())
    for name in ("ConvLReLU_2", "ConvLReLU_10", "ConvLReLU_12"):
        k = _leaf(serving_tree, "depth_net", name, "kernel")
        np.testing.assert_array_equal(
            sd[f"depth_net.{name}.weight"].numpy(), k.transpose(3, 2, 0, 1))
    k = _leaf(serving_tree, "fusion", "ScoreConv_0", "kernel")
    assert sd["fusion.ScoreConv_0.weight"].shape == (64, 131, 3, 3)
    np.testing.assert_array_equal(sd["fusion.ScoreConv_0.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))


def test_weight_bridge_rejects_mismatches(serving_tree):
    import copy

    extra = copy.deepcopy(serving_tree)
    extra["sr_head"]["Conv_9"] = {"kernel": np.zeros((3, 3, 64, 64), np.float32)}
    with pytest.raises(ValueError, match="no port parameter"):
        from_jax_params(extra, serving_config())
    missing = copy.deepcopy(serving_tree)
    del missing["fusion"]["Score1_0"]["bias"]
    with pytest.raises(ValueError, match="without a flax leaf"):
        from_jax_params(missing, serving_config())
    wrong = copy.deepcopy(serving_tree)
    wrong["flow_net"]["estimator_l1"]["Conv_0"]["kernel"] = np.zeros(
        (3, 3, 10, 2), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(wrong, serving_config())


def test_init_params_matches_lecun_scale():
    m = init_params(VSRModel(serving_config().model),
                    torch.Generator().manual_seed(0))
    w = m.sr_head.ResBlock_0.ConvLReLU_0.weight
    assert abs(float(w.detach().std()) * np.sqrt(64 * 9) - 1.0) < 0.05

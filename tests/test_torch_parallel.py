"""The port's parallel modes (``video_super_resolution_tpu_torch.parallel``,
``runtime/mesh.py``, the mesh train step) against the JAX package's mesh
programs on the 8-fake-device CPU mesh (``tests/test_parallel.py``).

The port runs one process a rank: each multi-rank case is a gloo job of 2
or 4 CPU processes (``parallel/launch.py``), at the tiny widths of
``tests/test_parallel.py``, with the JAX weights carried across
(``weights.from_jax_params``). Two jobs run every case: a 4-rank one
(temporal CP and its halo, time x space streaming, the dp + sp and the
TP train steps) and a 2-rank one (the dp train step, the TP forward).

Tolerances: against JAX, the composed model's (rtol 2e-3, atol 5e-4) and
the loss at rtol 1e-5; against the port's own unsharded forward, rtol
1e-4 / atol 1e-5; the halo values exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from video_super_resolution_tpu.config import MeshConfig as JMeshConfig
from video_super_resolution_tpu.config import TrainConfig as JTrainConfig
from video_super_resolution_tpu.config import VSRConfig as JVSRConfig
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel
from video_super_resolution_tpu.runtime.mesh import build_mesh as jbuild_mesh

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    VSRConfig,
)
from video_super_resolution_tpu_torch.models.common import _Conv3x3
from video_super_resolution_tpu_torch.parallel import launch
from video_super_resolution_tpu_torch.parallel.spatial import (
    halo_rows,
    strip_forward,
    strip_rows,
)
from video_super_resolution_tpu_torch.parallel.tensor import trunk_param_plan
from video_super_resolution_tpu_torch.runtime.mesh import local_mesh
from video_super_resolution_tpu_torch.training.state import create_train_state
from video_super_resolution_tpu_torch.training.step import make_train_step
from video_super_resolution_tpu_torch.weights import flax_path, from_jax_params
from test_parallel import TINY, _reference_sliding
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

JAX_TOL = dict(rtol=2e-3, atol=5e-4)
PORT_TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN = dict(warmup_steps=0, lr=1e-3, compute_dtype="float32")


def port_cfg(**train):
    model = ModelConfig(**{f.name: getattr(TINY, f.name)
                           for f in dataclasses.fields(ModelConfig)})
    return VSRConfig(model=model, train=TrainConfig(**train))


def port_model(state_dict, cfg):
    model = api.build_model(cfg, "cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def data():
    """The JAX TINY model's params (key 0) as a port state_dict, and the
    inputs of every case, from a seeded numpy generator."""
    rng = np.random.default_rng(0)
    jm = JVSRModel(cfg=TINY)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 3, 16, 16, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    return {
        "jmodel": jm, "params": params,
        "state_dict": from_jax_params(params, port_cfg()),
        "frames": rng.random((8, 16, 16, 3)).astype(np.float32),
        "stream_frames": rng.random((4, 40, 16, 3)).astype(np.float32),
        "batch": {"lr": rng.random((4, 3, 16, 16, 3)).astype(np.float32),
                  "hr": rng.random((4, 64, 64, 3)).astype(np.float32)},
        "window": rng.random((1, 3, 32, 48, 3)).astype(np.float32),
    }


def _tensors(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def four_ranks(data, tmp_path_factory):
    """One 4-rank gloo job: temporal (time 4), stream (time 2 x space 2),
    train_step (data 2 x space 2), tp_step (data 2 x model 2), tp_forward
    in bf16 (model 4)."""
    inputs = {"cases": ["temporal", "stream", "train_step", "tp_step",
                        "tp_forward"],
              "config": port_cfg(**TRAIN).to_json(),
              "tp_config": port_cfg(compute_dtype="bfloat16").to_json(),
              "window": torch.from_numpy(data["window"]),
              "state_dict": data["state_dict"],
              "frames": torch.from_numpy(data["frames"]),
              "stream_frames": torch.from_numpy(data["stream_frames"]),
              "stream_mesh": {"time": 2, "space": 2},
              "step_mesh": {"data": 2, "space": 2},
              "tp_mesh": {"data": 2, "model": 2},
              "batch": _tensors(data["batch"])}
    return launch.spawn(inputs, 4, str(tmp_path_factory.mktemp("four")),
                        device="cpu")


@pytest.fixture(scope="module")
def two_ranks(data, tmp_path_factory):
    """One 2-rank gloo job: train_step (data 2), tp_forward (model 2)."""
    inputs = {"cases": ["train_step", "tp_forward"],
              "config": port_cfg(**TRAIN).to_json(),
              "step_mesh": {"data": 2},
              "state_dict": data["state_dict"],
              "batch": _tensors(data["batch"]),
              "window": torch.from_numpy(data["window"])}
    return launch.spawn(inputs, 2, str(tmp_path_factory.mktemp("two")),
                        device="cpu")


def test_halo_exchange_values(four_ranks):
    """Interior ranks see their neighbours' frames, the edges replicate:
    JAX's own list."""
    got = torch.cat([r["temporal"]["halo"] for r in four_ranks]).tolist()
    assert got == [0, 0, 1, 2, 1, 2, 3, 4, 3, 4, 5, 6, 5, 6, 7, 7]


def test_temporal_shard_matches_unsharded(data, four_ranks):
    got = torch.cat([r["temporal"]["frames"] for r in four_ranks]).numpy()
    assert got.shape == (8, 64, 64, 3)
    want = _reference_sliding(data["jmodel"], data["params"], data["frames"], 3)
    np.testing.assert_allclose(got, want, **JAX_TOL)
    model = port_model(data["state_dict"], port_cfg(**TRAIN))
    mine = np.concatenate([api.upscale_window(model, torch.from_numpy(
        np.concatenate([data["frames"][[max(c - 1, 0)]], data["frames"][[c]],
                        data["frames"][[min(c + 1, 7)]]])[None])).numpy()
        for c in range(8)])
    np.testing.assert_allclose(got, mine, **PORT_TOL)


def test_streaming_time_space_matches_unsharded(data, four_ranks):
    """time 2 x space 2 at 40 rows: each space rank runs the tail on a real
    strip (halo 13 of 20 own rows). Every rank returns the whole clip. The
    port's one-rank reference runs its 4 windows 3 at a time."""
    from video_super_resolution_tpu.parallel.streaming import (
        make_streaming_program,
    )
    from video_super_resolution_tpu.runtime.mesh import AXIS_TIME

    outs = [r["stream"]["out"].numpy() for r in four_ranks]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    frames = data["stream_frames"]
    mesh_cfg = JMeshConfig(time=2, space=2)
    mesh = jbuild_mesh(mesh_cfg, devices=jax.devices()[:4])
    jcfg = JVSRConfig(model=TINY, mesh=mesh_cfg,
                      train=JTrainConfig(compute_dtype="float32"))
    program = make_streaming_program(jcfg, mesh, (40, 16), frames_per_device=2)
    want = np.asarray(program(data["params"], jax.device_put(
        jnp.asarray(frames), NamedSharding(mesh, P(AXIS_TIME)))))
    assert outs[0].shape == want.shape == (4, 160, 64, 3)
    np.testing.assert_allclose(outs[0], want, **JAX_TOL)
    model = port_model(data["state_dict"], port_cfg(**TRAIN))
    mine = api.stream_upscale(model, frames, port_cfg(**TRAIN),
                              local_mesh("cpu"), window_batch=3)
    np.testing.assert_allclose(outs[0], mine, **PORT_TOL)
    assert "('all_gather', 'gloo', 'host')" in four_ranks[0]["stream"]["transport"]


def test_data_parallel_grads_match_single(data, two_ranks):
    """The port's dp step over data 2 against JAX's ``make_train_step`` on
    a data 2 mesh and against the port's one-process step: every rank
    reports the global loss and grad_norm."""
    from video_super_resolution_tpu.runtime.mesh import AXIS_DATA
    from video_super_resolution_tpu.training import (
        create_train_state as jcreate_train_state,
    )
    from video_super_resolution_tpu.training import make_train_step as jstep

    a, b = (r["train_step"] for r in two_ranks)
    assert a == b
    mesh = jbuild_mesh(JMeshConfig(data=2), devices=jax.devices()[:2])
    jstate = jcreate_train_state(JVSRConfig(model=TINY,
                                            train=JTrainConfig(**TRAIN)))
    sharded = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(AXIS_DATA)))
               for k, v in data["batch"].items()}
    _, jm = jstep(mesh=mesh, donate=False)(jstate, sharded)
    np.testing.assert_allclose(a["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(a["grad_norm"], float(jm["grad_norm"]),
                               **JAX_TOL)

    cfg = port_cfg(**TRAIN)
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(data["state_dict"])
    _, m = make_train_step(mesh=cfg.mesh)(state, data["batch"])
    np.testing.assert_allclose(a["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(a["grad_norm"], float(m["grad_norm"]),
                               rtol=1e-5)


def test_dp_sp_train_step_matches_single(data, four_ranks):
    """data 2 x space 2 (``__graft_entry__.py``'s dp + sp step): strip
    losses weighted by their rows, gradients summed over space and
    averaged over data, against the port's one-process step."""
    got = [r["train_step"] for r in four_ranks]
    assert all(g == got[0] for g in got)
    cfg = port_cfg(**TRAIN)
    state = create_train_state(cfg, "cpu")
    state.model.load_state_dict(data["state_dict"])
    _, m = make_train_step()(state, data["batch"])
    for k in ("loss", "grad_norm", "psnr_proxy"):
        np.testing.assert_allclose(got[0][k], float(m[k]), rtol=1e-5)


def test_tensor_parallel_matches_single(data, two_ranks):
    """The TP forward over model 2 (conv1 on its Cout half, conv2 on its
    Cin half, one all-reduce a block) against JAX's ``make_tp_forward`` on
    a model 2 mesh and against the port's unsharded forward."""
    from video_super_resolution_tpu.parallel.tensor import (
        make_tp_forward,
        shard_params_tp,
    )

    outs = [r["tp_forward"]["out"].numpy() for r in two_ranks]
    np.testing.assert_array_equal(outs[0], outs[1])
    cfg = dataclasses.replace(TINY, warp_impl="gather")
    jm = JVSRModel(cfg=cfg, dtype=jnp.float32)
    mesh = jbuild_mesh(JMeshConfig(model=2), devices=jax.devices()[:2])
    x = jnp.asarray(data["window"])
    want = np.asarray(make_tp_forward(jm.apply, mesh)(
        shard_params_tp(data["params"], mesh), x))
    np.testing.assert_allclose(outs[0], want, **JAX_TOL)
    model = port_model(data["state_dict"], port_cfg(**TRAIN))
    mine = api.upscale_window(model, torch.from_numpy(data["window"])).numpy()
    np.testing.assert_allclose(outs[0], mine, **PORT_TOL)


def test_tp_forward_no_global_side_effect(two_ranks):
    """Building and running the TP copy leaves the unsharded model's
    parameters and its prepared-weight caches as they were."""
    for r in two_ranks:
        assert r["tp_forward"]["same_params"]
        assert r["tp_forward"]["same_caches"]


def test_tp_forward_bf16_partial_sums_at_four_ranks(data, four_ranks):
    """bf16 at model 4: each rank's conv2 partial sum is rounded to bf16
    before the f32 all-reduce (the kernel writes its input's dtype), n + 1
    roundings where the unsharded block has one. Measured against the f32
    forward, the TP output's error stays within twice the unsharded bf16
    forward's, and within the bf16 tolerance of that forward."""
    outs = [r["tp_forward"]["out"] for r in four_ranks]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    x = torch.from_numpy(data["window"])
    want = api.upscale_window(port_model(data["state_dict"],
                                         port_cfg(**TRAIN)), x).float()
    plain = api.upscale_window(port_model(
        data["state_dict"], port_cfg(compute_dtype="bfloat16")), x).float()
    got = outs[0].float()
    torch.testing.assert_close(got, plain, rtol=2e-2, atol=2e-2)
    err_tp = float((got - want).abs().max())
    err_plain = float((plain - want).abs().max())
    print(f"bf16 at model 4, max|diff| vs f32: TP {err_tp:.3e}, "
          f"unsharded {err_plain:.3e}")
    assert 0 < err_tp <= 2 * err_plain, (err_tp, err_plain)
    assert all(r["tp_forward"]["same_params"] for r in four_ranks)


def test_tp_plan_matches_jax_specs(data):
    """The port's plan splits exactly the leaves JAX's ``trunk_param_specs``
    shards, on the same axis (HWIO out = OIHW 0, HWIO in = OIHW 1)."""
    from video_super_resolution_tpu.parallel.tensor import trunk_param_specs

    mesh = jbuild_mesh(JMeshConfig(model=2), devices=jax.devices()[:2])
    specs = trunk_param_specs(data["params"], mesh)
    plan = trunk_param_plan(data["state_dict"])
    assert sum(d is not None for d in plan.values()) == 3 * TINY.sr_blocks
    for key, dim in plan.items():
        spec = specs
        for p in flax_path(key):
            spec = spec[p]
        axes = [i for i, a in enumerate(spec) if a is not None]
        if key.endswith(".weight"):
            want = {3: 0, 2: 1}.get(axes[0]) if axes else None
        else:
            want = axes[0] if axes else None
        assert dim == want, (key, spec)


def test_tp_train_step_matches_single(data, four_ranks):
    """One TP step on data 2 x model 2 (the per-block all-reduce and the
    data mean together): loss and grad_norm against JAX's
    ``make_tp_train_step``; ResBlock_0's conv1 kernel after the update,
    the model ranks' shards joined on Cout, against JAX's (still sharded
    there)."""
    from video_super_resolution_tpu.parallel.tensor import (
        make_tp_train_step,
        shard_params_tp,
    )
    from video_super_resolution_tpu.runtime.mesh import AXIS_DATA
    from video_super_resolution_tpu.training.state import (
        create_train_state as jcreate_train_state,
    )

    got = [r["tp_step"] for r in four_ranks]
    assert all(g["loss"] == got[0]["loss"] for g in got)
    shards = {g["model_index"]: g["conv1"] for g in got}
    kernel = torch.cat([shards[0], shards[1]]).numpy()

    cfg = JVSRConfig(model=dataclasses.replace(TINY, warp_impl="gather"),
                     train=JTrainConfig(**TRAIN))
    state = jcreate_train_state(cfg)
    mesh = jbuild_mesh(JMeshConfig(data=2, model=2), devices=jax.devices()[:4])
    tp_state = state.replace(params=shard_params_tp(state.params, mesh))
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P(AXIS_DATA)))
             for k, v in data["batch"].items()}
    new, m = make_tp_train_step(mesh)(tp_state, batch)
    np.testing.assert_allclose(got[0]["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got[0]["grad_norm"], float(m["grad_norm"]),
                               **JAX_TOL)
    want = np.asarray(
        new.params["sr_head"]["ResBlock_0"]["ConvLReLU_0"]["kernel"])
    np.testing.assert_allclose(kernel, want.transpose(3, 2, 0, 1),
                               rtol=2e-5, atol=2e-6)


# ------------------------------------------------ spatial strips, in process

def _shift_tail(model):
    """Make every conv after the warp read only the row above (tap (0, 1)
    of a random channel mix): each such conv then carries a row's value one
    row down at full strength, and the halo's last row reaches the strip's
    first own row at O(1), not at the rounding level."""
    mods = [model.fusion, model.sr_head]
    if not model.cfg.warp_features:
        mods += [model.frame_encoder_0, model.frame_encoder_1]
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in mods:
            for m in mod.modules():
                if isinstance(m, _Conv3x3):
                    w = torch.zeros_like(m.weight)
                    w[:, :, 0, 1] = torch.randn(w.shape[:2], generator=g) \
                        / m.weight.shape[1] ** 0.5
                    m.weight.copy_(w)


# layout: (model options, halo rows at TINY's two ResBlocks): encode 2 +
# fusion 4 + head (first conv, 2 x 2 block convs, trunk conv = 6, then the
# subpixel conv 1, or the two_stage upsample tail 2, or espcn_mid + subpixel
# 2 with warp_features, which encodes before the warp)
SPATIAL = {"espcn": ({}, 13),
           "two_stage": ({"sr_head_style": "two_stage"}, 14),
           "warp_features+espcn_mid": ({"warp_features": True,
                                        "sr_espcn_mid": 24}, 12)}


@pytest.mark.parametrize("layout", list(SPATIAL))
def test_spatial_strips_exact_and_halo_tight(layout):
    """Strips with ``halo_rows`` rows of halo join to the unsharded forward
    (46 LR rows, padded to 48: both the padded edge and the SR head's crop
    at h0); with one row fewer they do not, at the same tolerance. The
    tail's convs read only the row above (``_shift_tail``), so the missing
    row shows far above the rounding (it enters through the fusion's
    softmax weights: 3e-4 and more, against 2e-7 of rounding)."""
    extra, halo = SPATIAL[layout]
    cfg = port_cfg(compute_dtype="float32")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **extra))
    model = api.build_model(cfg, "cpu", seed=0)
    _shift_tail(model)
    assert halo_rows(model) == halo
    x = torch.rand((1, 3, 46, 24, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(x)
        for n in (2, 3):
            assert strip_rows(46, n, halo, 48)[1].lo > 0
            got = torch.cat([strip_forward(model, x, i, n)[0]
                             for i in range(n)], dim=1)
            torch.testing.assert_close(got, want, **PORT_TOL)
            short = torch.cat([strip_forward(model, x, i, n, halo - 1)[0]
                               for i in range(n)], dim=1)
            assert not torch.allclose(short, want, **PORT_TOL), (n, layout)

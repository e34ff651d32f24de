"""The port's training path on the CPU against the JAX package's: the loss
and every parameter's gradient at a tiny config (f32, weights drawn in the
port and carried to flax by path), one train step's metrics, the
schedules and the optimizer on identical gradients, and the port's own
train loop, multi-step, compact decode, checkpoints and resume.

Tolerances: gradients and metrics of the composed model rtol 2e-3, atol
5e-4 (tests/test_torch_vsr.py's); optimizer parameters rtol 1e-6 (f32
rounding of the same update); schedules rtol 1e-6 with atol 1e-6 * lr
(optax computes them in f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_super_resolution_tpu import config as jconfig
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel
from video_super_resolution_tpu.ops.losses import charbonnier_loss as jax_charbonnier
from video_super_resolution_tpu.training import state as jstate
from video_super_resolution_tpu.training.step import make_train_step as jax_train_step

from video_super_resolution_tpu_torch.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
    VSRConfig,
)
from video_super_resolution_tpu_torch.data.dataset import ClipDataset
from video_super_resolution_tpu_torch.data.synthetic import moving_gradient_clip
from video_super_resolution_tpu_torch.models import common
from video_super_resolution_tpu_torch.models.common import init_params
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.ops.fused_conv import unpack_conv3x3_weight
from video_super_resolution_tpu_torch.ops.losses import charbonnier_loss
from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
from video_super_resolution_tpu_torch.training.loop import train
from video_super_resolution_tpu_torch.training.state import (
    TrainState,
    create_train_state,
    make_optimizer,
    make_schedule,
)
from video_super_resolution_tpu_torch.training.step import (
    decode_batch,
    make_multi_train_step,
    make_train_step,
)
from video_super_resolution_tpu_torch.weights import to_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
TINY = dict(pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
            context_channels=(16, 16), depth_channels=8, depth_levels=2,
            fusion_channels=16, sr_channels=16, sr_blocks=2,
            warp_impl="gather")


def tiny_cfg(**train_kw):
    kw = dict(warmup_steps=0, lr=1e-3, compute_dtype="float32")
    kw.update(train_kw)
    return VSRConfig(model=ModelConfig(**TINY), train=TrainConfig(**kw))


def jax_train_cfg(cfg: TrainConfig) -> jconfig.TrainConfig:
    return jconfig.TrainConfig(**dataclasses.asdict(cfg))


def batch(seed, b=2, h=16, w=16):
    rng = np.random.default_rng(seed)
    return {"lr": rng.random((b, 3, h, w, 3)).astype(np.float32),
            "hr": rng.random((b, 4 * h, 4 * w, 3)).astype(np.float32)}


# ------------------------------------------------ against the JAX package

@pytest.fixture(scope="module")
def carried():
    """A tiny f32 port model, its params as a flax tree, the JAX model."""
    model = init_params(VSRModel(ModelConfig(**TINY)),
                        torch.Generator().manual_seed(0))
    jm = JVSRModel(cfg=jconfig.ModelConfig(**TINY), dtype=jnp.float32)
    return model, to_jax_params(model.state_dict()), jm


def test_loss_gradients_match_jax(carried):
    """Every parameter's gradient of the Charbonnier loss, through the
    three kernels' Functions, against jax.value_and_grad of the JAX train
    step's loss."""
    model, params, jm = carried
    bt = batch(0)

    def loss_fn(p):
        return jax_charbonnier(jm.apply({"params": p}, jnp.asarray(bt["lr"])),
                               jnp.asarray(bt["hr"]), 1e-6)

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    model.zero_grad(set_to_none=True)
    loss = charbonnier_loss(model(torch.from_numpy(bt["lr"])),
                            torch.from_numpy(bt["hr"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = to_jax_params({k: p.grad for k, p in model.named_parameters()})
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert len(flat_got) == len(flat_want) > 60
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        assert np.abs(w).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, **MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_step_metrics_match_jax(carried):
    model, params, jm = carried
    cfg = tiny_cfg()
    bt = batch(1)
    jst = jstate.TrainState.create(apply_fn=jm.apply, params=params,
                                   tx=jstate.make_optimizer(jax_train_cfg(cfg.train)))
    _, jm_metrics = jax_train_step(donate=False)(
        jst, {k: jnp.asarray(v) for k, v in bt.items()})

    port = VSRModel(cfg.model)
    port.load_state_dict(model.state_dict())
    st = TrainState(port, make_optimizer(port.parameters(), cfg.train),
                    make_schedule(cfg.train), cfg.train.grad_clip)
    st, metrics = make_train_step()(st, bt)
    assert set(metrics) == {"loss", "psnr_proxy", "grad_norm"} == set(jm_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jm_metrics[k]),
                                   **MODEL_TOL, err_msg=k)
    assert st.step == 1


@pytest.mark.parametrize("kind", ["const", "step", "cosine"])
@pytest.mark.parametrize("warmup", [0, 7])
def test_schedule_matches_optax(kind, warmup):
    cfg = TrainConfig(lr=3e-4, lr_schedule=kind, steps=60, warmup_steps=warmup,
                      lr_step_every=13, lr_step_gamma=0.5)
    want = jstate.make_schedule(jax_train_cfg(cfg))
    got = make_schedule(cfg)
    counts = range(80)
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(want(c)) for c in counts],
                               rtol=1e-6, atol=1e-6 * cfg.lr)
    if warmup:
        assert got(0) == 0.0


@pytest.mark.parametrize("kind,warmup,decay", [
    ("const", 0, 0.0), ("step", 2, 0.0), ("cosine", 3, 0.0),
    ("cosine", 0, 0.01), ("step", 0, 0.01), ("const", 2, 0.01)])
def test_optimizer_matches_optax(kind, warmup, decay):
    """The same gradient arrays through optax's chain (clip, adam/adamw at
    the schedule) and through TrainState.apply_gradients; some steps'
    norms exceed the clip."""
    cfg = TrainConfig(lr=1e-2, lr_schedule=kind, steps=10, warmup_steps=warmup,
                      lr_step_every=3, weight_decay=decay, grad_clip=1.0)
    rng = np.random.default_rng(0)
    init = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (3.0 if i % 2 else 0.1))
              .astype(np.float32) for k, v in init.items()} for i in range(8)]

    tx = jstate.make_optimizer(jax_train_cfg(cfg))
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(jp)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()})
    st = TrainState(module, make_optimizer(module.parameters(), cfg),
                    make_schedule(cfg), cfg.grad_clip)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, opt_state = tx.update(jg, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        want_norm = float(optax.global_norm(jg))
        for k, p in module.items():
            p.grad = torch.tensor(g[k])       # a copy: the clip scales it
        norm = st.apply_gradients()
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-8)
    assert st.step == len(grads)


# --------------------------------------------------------- the port alone

def test_loss_falls_on_a_fixed_batch():
    st = create_train_state(tiny_cfg(), "cpu")
    step = make_train_step()
    bt = batch(2)
    losses = []
    for _ in range(8):
        st, m = step(st, bt)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert st.step == 8


def test_multi_step_equals_sequential():
    cfg = tiny_cfg()
    batches = [batch(10 + i) for i in range(3)]
    a = create_train_state(cfg, "cpu")
    step = make_train_step()
    for bt in batches:
        a, ma = step(a, bt)
    b = create_train_state(cfg, "cpu")
    stacked = {k: np.stack([bt[k] for bt in batches]) for k in batches[0]}
    b, mb = make_multi_train_step()(b, stacked)
    assert a.step == b.step == 3
    assert float(ma["loss"]) == float(mb["loss"])
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), n


def test_compact_batch_decode():
    """uint8 HR is divided by 255 on the device, a bf16 LR cast to f32; the
    loss of the compact batch is the f32 batch's to bf16-input precision."""
    u8 = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    hr = (u8 / 255.0).astype(np.float32)
    lr = np.random.default_rng(1).random((2, 3, 16, 16, 3)).astype(np.float32)
    lr16 = torch.from_numpy(lr).to(torch.bfloat16)
    dlr, dhr = decode_batch({"lr": lr16, "hr": u8}, torch.device("cpu"))
    assert dlr.dtype == dhr.dtype == torch.float32
    assert torch.equal(dhr, torch.from_numpy(u8).to(torch.float32) / 255.0)
    assert torch.equal(dlr, lr16.to(torch.float32))
    step = make_train_step()
    _, m_full = step(create_train_state(tiny_cfg(), "cpu"), {"lr": lr, "hr": hr})
    _, m_compact = step(create_train_state(tiny_cfg(), "cpu"),
                        {"lr": lr16, "hr": u8})
    np.testing.assert_allclose(float(m_compact["loss"]), float(m_full["loss"]),
                               rtol=2e-3)


def test_parallel_mesh_is_not_ported():
    """The parallel modes are ported now (tests/test_torch_parallel.py):
    a data 2 mesh builds its step; without a process group to run it on,
    the first step raises and says what is missing."""
    step = make_train_step(mesh=MeshConfig(data=2))
    with pytest.raises(ValueError, match="process group"):
        step(create_train_state(tiny_cfg(), "cpu"), batch(2))


def test_prepared_weights_rebuilt_once_per_step(monkeypatch):
    """The optimizer's in-place update bumps the parameters' _version: each
    conv's kernel layout is rebuilt once a step and is never stale."""
    built = []
    real = common.prepare_conv3x3_weight
    monkeypatch.setattr(common, "prepare_conv3x3_weight",
                        lambda *a: built.append(1) or real(*a))
    st = create_train_state(tiny_cfg(), "cpu")
    step = make_train_step()
    bt = batch(3)
    st, _ = step(st, bt)
    per_step = len(built)
    convs = [m for m in st.model.modules() if isinstance(m, common._Conv3x3)]
    assert per_step == sum(len(m._prepared) for m in convs) > 20
    for _ in range(2):
        st, _ = step(st, bt)
    assert len(built) == 3 * per_step
    # after the last update every layout is stale and is rebuilt, once, on
    # its next use
    for m in convs:
        for dt, lo, hi, with_bias in list(m._prepared):
            prep = m.prepared(dt, slice(lo, hi), with_bias)
            assert prep is m.prepared(dt, slice(lo, hi), with_bias)
            assert torch.equal(unpack_conv3x3_weight(prep),
                               m.weight[:, lo:hi].detach().to(dt))
    assert len(built) == 4 * per_step


# -------------------------------------------------- checkpoints and resume

def test_checkpoint_round_trip_and_resume(tmp_path):
    cfg = tiny_cfg()
    step = make_train_step()
    st = create_train_state(cfg, "cpu")
    for i in range(2):
        st, _ = step(st, batch(20 + i))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    mgr.save(2, st, cfg)
    assert mgr.latest_step() == 2

    fresh = create_train_state(cfg, "cpu", seed=7)
    restored, at = mgr.restore(fresh)
    assert at == 2 and restored.step == 2
    for (n, a), b in zip(st.model.named_parameters(), restored.model.parameters()):
        assert torch.equal(a, b), n
    sa, sb = st.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k]["step"] == sb[k]["step"] == 2
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][name], sb[k][name])
    # resuming continues the same run
    st, ma = step(st, batch(30))
    restored, mb = step(restored, batch(30))
    assert float(ma["loss"]) == float(mb["loss"])
    for a, b in zip(st.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)

    assert mgr.restore_config() == cfg
    # the config JSON loads in the JAX package too
    assert (jconfig.VSRConfig.from_json(mgr.restore_config().to_json()).to_json()
            == cfg.to_json())
    for s in (3, 4):
        mgr.save(s, st, cfg)
    assert mgr.steps() == [3, 4]
    assert not [p for p in (tmp_path / "ckpt").iterdir() if p.suffix == ".tmp"]


def test_restore_without_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"))
    assert mgr.latest_step() is None
    assert mgr.restore(create_train_state(tiny_cfg(), "cpu")) == (None, None)
    assert mgr.restore_config() is None


def test_train_loop_logs_checkpoints_evaluates_and_resumes(tmp_path):
    import json

    clips = {f"c{i}": moving_gradient_clip(4, 64, 64, 1.0 + i, -0.5, seed=i)[0]
             for i in range(2)}
    ds = ClipDataset(clips_hr=clips, crop_size=16, seed=0)
    cfg = tiny_cfg(ckpt_dir=str(tmp_path / "run"), ckpt_every=2, log_every=2,
                   keep_ckpts=5)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=2,
                                               crop_size=16))
    out = train(cfg, ds, eval_ds=ds, max_steps=4, eval_every=4, device="cpu")
    assert out["state"].step == 4
    assert out["ckpt"].steps() == [2, 4]
    avg = out["eval"]["__average__"]
    assert np.isfinite(avg["psnr"]) and 0 < avg["ssim"] <= 1 and avg["frames"] == 8
    logs = [json.loads(l) for l in (tmp_path / "run" / "train.jsonl").read_text().splitlines()]
    train_logs = [r for r in logs if "steps_per_s" in r]
    assert [r["step"] for r in train_logs] == [2, 4]
    assert all(r["frames_per_s"] == 2 * r["steps_per_s"] for r in train_logs)
    assert any("eval_psnr" in r for r in logs)

    again = train(cfg, ds, max_steps=6, device="cpu")
    assert again["state"].step == 6
    assert again["ckpt"].steps() == [2, 4, 6]


def test_train_refuses_the_shared_default_ckpt_dir():
    """The config's default checkpoint directory is one fixed path for
    every run on the host: ``train`` asks for a directory of the run's own
    before it builds anything or writes there."""
    assert tiny_cfg().train.ckpt_dir == TrainConfig.ckpt_dir
    with pytest.raises(ValueError, match="ckpt_dir"):
        train(tiny_cfg(), ClipDataset(
            clips_hr={"c": moving_gradient_clip(3, 32, 32, 1.0, 0.5)[0]},
            crop_size=8), device="cpu")

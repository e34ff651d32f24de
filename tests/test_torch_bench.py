"""The port's headline bench (``video_super_resolution_tpu_torch/bench.py``)
against the JAX repo's ``bench.py``, on the CPU at TINY widths: its
serving and train chains against JAX's ``lax.scan`` bodies (rebuilt here:
they are closures inside JAX's ``main()``), its line's keys against the
ones JAX prints, its metric names, its baseline file, and that it runs
nothing on the CPU unless asked.

Tolerances: the chains' sums rtol 2e-3 (serving also atol 5e-4) and the
parameters after the train chain rtol 2e-3, atol 5e-4: the composed
model's.
"""

import ast
import dataclasses
import functools
import json
import math
import pathlib

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

from video_super_resolution_tpu_torch import api, bench
from video_super_resolution_tpu_torch.config import ModelConfig, TrainConfig, VSRConfig
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.training.state import (
    TrainState,
    make_optimizer,
    make_schedule,
)
from video_super_resolution_tpu_torch.weights import from_jax_params, to_jax_params
from test_parallel import TINY
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODEL_TOL = dict(rtol=2e-3, atol=5e-4)
TINY_FIELDS = {f.name: getattr(TINY, f.name)
               for f in dataclasses.fields(ModelConfig)}
SERVING_WINDOW = (1, 3, 32, 48, 3)
N = 3
# small CPU runs of main(): 32x48 serving, two forwards a chain
SMALL = ["--cpu", "--h", "32", "--w", "48", "--frames", "2", "--warmup", "0"]


def tiny_cfg(**train_kw) -> VSRConfig:
    return VSRConfig(model=ModelConfig(**TINY_FIELDS),
                     train=TrainConfig(compute_dtype="float32", **train_kw))


def jax_model() -> JVSRModel:
    return JVSRModel(cfg=jconfig.ModelConfig(**{**TINY_FIELDS,
                                                "warp_impl": "gather"}),
                     dtype=jnp.float32)


def carried(jm: JVSRModel, x: np.ndarray):
    """JAX's initial parameters and a port model that carries them."""
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    port = VSRModel(ModelConfig(**TINY_FIELDS))
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                         port.cfg), strict=True)
    return params, port


def test_serving_chain_matches_jax_scan():
    """JAX's serving scan (``bench.py:187-193``) against ``serving_chain``."""
    jm = jax_model()
    x = np.random.default_rng(0).random(SERVING_WINDOW).astype(np.float32)
    params, port = carried(jm, x)

    @functools.partial(jax.jit, static_argnames=("n",))
    def chained(params, w0, n):
        def body(w, _):
            hr = jm.apply({"params": params}, w)
            dep = jnp.mean(hr).astype(jnp.float32) * jnp.float32(1e-12)
            return w + dep, jnp.mean(hr)
        _, means = jax.lax.scan(body, w0, None, length=n)
        return jnp.sum(means)

    want = float(chained(params, jnp.asarray(x), N))
    got = bench.serving_chain(port.eval(), torch.from_numpy(x), N)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, **MODEL_TOL)


def test_train_chain_matches_jax_scan():
    """JAX's train scan (``bench.py:53-67``: value-and-grad, ``tx.update``,
    ``apply_updates``) against ``train_chain`` (``make_train_step``, the
    step users train with) from the same parameters,
    warmup 0 so that the first update moves them: the summed losses and
    every parameter after the chain."""
    cfg = tiny_cfg(warmup_steps=0, lr=1e-3)
    rng = np.random.default_rng(0)
    lr = rng.random((4, 3, 16, 16, 3)).astype(np.float32)
    hr = rng.random((4, 64, 64, 3)).astype(np.float32)
    jm = jax_model()
    params, port = carried(jm, lr)
    tx = jstate.make_optimizer(jconfig.TrainConfig(**dataclasses.asdict(cfg.train)))
    eps = cfg.train.charbonnier_eps

    def loss_fn(p):
        return jax_charbonnier(jm.apply({"params": p}, jnp.asarray(lr)),
                               jnp.asarray(hr), eps)

    @functools.partial(jax.jit, static_argnames=("n",))
    def chained(params, opt_state, n):
        def body(carry, _):
            p, o = carry
            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, o = tx.update(grads, o, p)
            return (optax.apply_updates(p, updates), o), loss
        (p, _), losses = jax.lax.scan(body, (params, opt_state), None,
                                      length=n)
        return jnp.sum(losses), p

    want_sum, want_params = chained(params, tx.init(params), N)
    port.train()
    state = TrainState(port, make_optimizer(port.parameters(), cfg.train),
                       make_schedule(cfg.train), cfg.train.grad_clip)
    batch = {"lr": torch.from_numpy(lr), "hr": torch.from_numpy(hr)}
    got = bench.train_chain(state, batch, N, eps)
    assert state.step == N
    np.testing.assert_allclose(got.item(), float(want_sum), rtol=2e-3)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_params))
    flat_start = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_got = jax.tree_util.tree_leaves_with_path(to_jax_params(port.state_dict()))
    assert len(flat_got) == len(flat_want) > 60
    moved = 0.0
    for path, g in flat_got:
        w = np.asarray(flat_want[path])
        np.testing.assert_allclose(g, w, **MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))
        moved = max(moved, float(np.abs(w - np.asarray(flat_start[path])).max()))
    assert moved > 2e-3     # 3 Adam steps at lr 1e-3


def jax_line_keys():
    """The keys of the JSON lines JAX's bench.py prints, in order: its
    train line first, then its serving line."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    return [[k.value for k in node.args[0].keys] for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
            and node.args and isinstance(node.args[0], ast.Dict)]


def last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("train", [False, True], ids=["serving", "train"])
def test_main_prints_jax_keys_then_the_ports(train, capsys, tmp_path,
                                             monkeypatch):
    monkeypatch.setattr(bench, "BASELINE_FILE", str(tmp_path / "b.json"))
    jax_train, jax_serving = jax_line_keys()
    assert bench.main(SMALL + (["--train"] if train else []),
                      cfg=tiny_cfg()) == 0
    line = last_line(capsys)
    unit = "step" if train else "frame"
    want = ((jax_train + ["device"]) if train else jax_serving) + [
        f"device_ms_per_{unit}", f"busy_ms_per_{unit}", "idle_share",
        "launches"]
    assert list(line) == want
    assert line["metric"] == ("train_steps_per_sec_b4_crop64" if train else
                              "frames_per_sec_per_chip_32x48_to_x4")
    assert line["unit"] == ("steps/s" if train else "frames/s/chip")
    assert line["device"] == "cpu" and line[f"device_ms_per_{unit}"] is None
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["vs_baseline"] == 1.0 and line["compile_s"] >= 0
    assert math.isfinite(line["idle_share"])
    assert line[f"busy_ms_per_{unit}"] > 0
    # the CPU runs the plain versions: no kernel launches
    assert line["launches"] == {"conv3x3": 0, "correlation": 0, "warp": 0}
    if train:
        assert line["frames_per_s"] == pytest.approx(4 * line["value"], abs=0.01)
    else:
        assert line["out_shape"] == [1, 128, 192, 3]


@pytest.mark.parametrize("argv,want", [
    ([], "frames_per_sec_per_chip_540x960_to_x4"),
    (["--quick"], "frames_per_sec_per_chip_180x320_to_x4"),
    (["--window", "3"], "frames_per_sec_per_chip_540x960_to_x4"),
    (["--window", "5"], "frames_per_sec_per_chip_540x960_to_x4_b1_w5"),
    (["--batch", "2", "--quick"], "frames_per_sec_per_chip_180x320_to_x4_b2_w3"),
    (["--train", "--window", "5"], "train_steps_per_sec_b4_crop64"),
])
def test_metric_names(argv, want):
    """JAX's names (``bench.py:90,219-221``)."""
    assert bench.metric_name(bench.parse_args(argv)) == want


def test_config_matches_jax_bench():
    """``--window`` on ``serving_config()``, as JAX's bench applies it
    (``bench.py:156-161``). JAX's ``--pallas`` picks a kernel route the
    port does not have (its CUDA tensors always take the kernels), so the
    port's bench rejects it."""
    args = bench.parse_args(["--window", "5"])
    jcfg = jconfig.serving_config()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, window=5))
    assert bench.bench_config(args).to_json() == jcfg.to_json()
    assert bench.bench_config(bench.parse_args([])).to_json() == \
        jconfig.serving_config().to_json()
    with pytest.raises(SystemExit):
        bench.parse_args(["--pallas"])


def test_record_baseline_then_vs_baseline(tmp_path, monkeypatch, capsys):
    """``--record-baseline`` writes the value and the device to the port's
    own file; the next run reads it back. The JAX repo's root baseline
    (TPU figures) is never touched."""
    root_file = ROOT / "bench_baseline.json"
    root_before = root_file.read_bytes()
    assert pathlib.Path(bench.BASELINE_FILE) == (
        ROOT / "video_super_resolution_tpu_torch" / "bench_baseline.json")
    path = tmp_path / "baseline.json"
    monkeypatch.setattr(bench, "BASELINE_FILE", str(path))
    path.write_text(json.dumps({"other_metric": 3.0}))
    cfg = tiny_cfg()
    bench.main(SMALL + ["--record-baseline"], cfg=cfg)
    first = last_line(capsys)
    assert first["vs_baseline"] == 1.0
    rec = json.loads(path.read_text())
    metric = first["metric"]
    assert rec["other_metric"] == 3.0
    assert rec[metric] == pytest.approx(first["value"], abs=1e-4)
    assert rec["device"] == {metric: "cpu"}
    rec[metric] = 1e-3
    path.write_text(json.dumps(rec))
    bench.main(SMALL, cfg=cfg)
    second = last_line(capsys)
    assert second["vs_baseline"] == pytest.approx(second["value"] / 1e-3,
                                                  rel=1e-3)
    assert json.loads(path.read_text())[metric] == 1e-3
    assert root_file.read_bytes() == root_before


@pytest.mark.parametrize("argv", [[], ["--train"]], ids=["serving", "train"])
def test_main_without_a_gpu_raises(argv, monkeypatch):
    """No fallback: without ``--cpu`` the bench asks for the card and
    raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def built(*a, **k):
        raise AssertionError("the bench built a model on the CPU")

    monkeypatch.setattr(api, "build_model", built)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(argv)

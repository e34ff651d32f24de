"""The plain reference against the port's plain CPU path at tiny widths:
the forward of both configurations and the first train steps."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import VSRConfig
from video_super_resolution_tpu_torch.training import create_train_state
from video_super_resolution_tpu_torch.training.step import make_train_step
from vsr_bench import weights
from vsr_bench.reference import train as reftrain
from vsr_bench.reference import vsr as reference
from vsr_bench.tests.conftest import TINY_MODEL

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_config(name: str, **train) -> VSRConfig:
    with open(os.path.join(ROOT, "vsr_bench", "configs", name + ".json")) as f:
        d = json.load(f)["vsr_config"]
    d["model"].update(TINY_MODEL)
    d["train"].update(compute_dtype="float32", **train)
    return VSRConfig.from_dict(d)


@pytest.mark.parametrize("name", ["espcn", "two_stage_wf"])
@pytest.mark.parametrize("hw", [(27, 45), (32, 64)])
def test_forward_matches_port(name, hw):
    cfg = tiny_config(name)
    m = dataclasses.asdict(cfg.model)
    model = api.build_model(cfg, "cpu")
    w = weights.make(reference.param_shapes(m), 2 ** 31 + 5, torch.device("cpu"))
    weights.load(model, w)
    win = torch.rand(1, 3, *hw, 3, generator=torch.Generator().manual_seed(1))
    out = api.upscale_window(model, win)
    with torch.no_grad():
        ref = reference.forward(w, m, win)
    assert ref.shape == out.shape == (1, 4 * hw[0], 4 * hw[1], 3)
    assert float((out - ref).abs().max()) < 1e-5


def test_parameter_tree_matches_port():
    for name in ("espcn", "two_stage_wf"):
        cfg = tiny_config(name)
        model = api.build_model(cfg, "cpu")
        shapes = reference.param_shapes(dataclasses.asdict(cfg.model))
        assert {n: tuple(p.shape) for n, p in model.named_parameters()} == shapes


def test_train_steps_match_port():
    cfg = tiny_config("espcn", warmup_steps=1, lr=1e-3)
    m, t = dataclasses.asdict(cfg.model), dataclasses.asdict(cfg.train)
    w = weights.make(reference.param_shapes(m), 9, torch.device("cpu"))
    state = create_train_state(cfg, "cpu")
    weights.load(state.model, w)
    rng = np.random.default_rng(0)
    batches = [{"lr": rng.random((2, 3, 16, 16, 3), np.float32),
                "hr": rng.random((2, 64, 64, 3), np.float32)} for _ in range(3)]
    step = make_train_step(cfg.train.charbonnier_eps)
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    r = reftrain.steps(reference.forward, w, m, t,
                       [{k: torch.from_numpy(v) for k, v in b.items()}
                        for b in batches])
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-5)
    # Adam's steps are ~lr = 1e-3 an element; where a gradient is near 0 its
    # sign, and so the element's step, rests on rounding: elements to 1e-5,
    # each leaf's norm to 1e-3. A leaf whose gradient is 0 but for rounding
    # (the score's bias under the softmax over neighbours) moves by
    # round-off alone and is left out, as the cell's check leaves it out.
    g = {n: float(v.norm()) for n, v in r["first_grad"].items()}
    med = float(np.median(list(g.values())))
    for n, p in state.model.named_parameters():
        if g[n] < 1e-3 * med:
            assert n == "fusion.Score1_0.bias"
            continue
        moved = (p.detach() - w[n])
        np.testing.assert_allclose(moved.numpy(), r["change"][n].numpy(),
                                   atol=1e-5, err_msg=n)
        assert float(moved.norm()) == pytest.approx(
            float(r["change"][n].norm()), rel=1e-3), n


def test_schedule_and_clip_conventions():
    t = {"lr": 1e-4, "warmup_steps": 2000, "lr_schedule": "cosine",
         "steps": 300000}
    assert reftrain.learning_rate(t, 0) == 0.0
    assert reftrain.learning_rate(t, 1000) == pytest.approx(5e-5)
    assert reftrain.learning_rate(t, 2000) == pytest.approx(1e-4)
    assert reftrain.learning_rate(t, 300000) == pytest.approx(1e-6)


def test_frozen_degradation_matches_port():
    from video_super_resolution_tpu_torch.data.degrade import degrade_bicubic
    from vsr_bench import content

    hr = np.random.default_rng(3).random((2, 3, 64, 96, 3)).astype(np.float32)
    ours = content.degrade(torch.from_numpy(hr), 4).numpy()
    np.testing.assert_allclose(ours, degrade_bicubic(hr, 4), atol=1e-6)

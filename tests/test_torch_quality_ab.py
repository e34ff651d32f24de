"""The port's trained-quality A/B tool
(``video_super_resolution_tpu_torch/tools/quality_ab.py``) against the JAX
package's ``tools/quality_ab.py``, on the CPU: the seven variants'
configs, the clips, ``run_variant`` from the same initial weights (3
steps, the JAX tool's own ``run_variant`` as the reference), ``main`` and
the card path without a GPU.

Tolerances: the mean loss rtol 2e-3 (the composed model's, as
``tests/test_torch_training.py``), eval PSNR 0.01 dB and SSIM 1e-4 (as
``tests/test_torch_quality.py``).
"""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from video_super_resolution_tpu.evaluation import evaluate as jeval
from video_super_resolution_tpu.training import state as jstate

from video_super_resolution_tpu_torch.tools import quality_ab as qa
from video_super_resolution_tpu_torch.weights import from_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jtool():
    """The JAX tool, loaded from its file (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_quality_ab", ROOT / "tools" / "quality_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clips():
    return qa.make_data()


def test_variants_match_jax(jtool):
    assert qa.VARIANTS == jtool.VARIANTS


@pytest.mark.parametrize("variant", list(qa.VARIANTS))
def test_small_cfg_matches_jax(jtool, variant):
    """Field by field: every field of both packages' config trees."""
    got = dataclasses.asdict(qa.small_cfg(**qa.VARIANTS[variant]))
    want = dataclasses.asdict(jtool.small_cfg(**jtool.VARIANTS[variant]))
    assert got == want
    assert got["train"]["steps"] == 1000 and got["data"]["crop_size"] == 24


def test_make_data_matches_jax(jtool, clips):
    want = jtool.make_data()
    assert list(clips) == list(want) == [f"clip{i}" for i in range(8)]
    for k in want:
        assert clips[k].shape == (7, 96, 128, 3)
        np.testing.assert_array_equal(clips[k], want[k], err_msg=k)


@pytest.mark.parametrize("variant", ["tpu_defaults", "two_stage_head"])
def test_run_variant_matches_jax(jtool, clips, monkeypatch, variant):
    """Both tools' ``run_variant`` for 3 steps from JAX's initial
    parameters (the port's carried by ``from_jax_params``): the same
    batches, updates and held-out evaluation. The JAX tool rounds its
    record, so its evaluation is read unrounded from ``evaluate_all``."""
    steps = 3
    jcfg = jtool.small_cfg(**jtool.VARIANTS[variant])
    cfg = qa.small_cfg(**qa.VARIANTS[variant])
    params = from_jax_params(jstate.create_train_state(jcfg).params, cfg)

    evals = []
    real = jeval.evaluate_all
    monkeypatch.setattr(jeval, "evaluate_all",
                        lambda *a, **k: evals.append(real(*a, **k)) or evals[-1])
    want = jtool.run_variant(variant, jcfg, clips, steps)
    got, state = qa.run_variant(variant, cfg, clips, steps, device="cpu",
                                params=params)

    assert state.step == steps
    assert set(want) <= set(got)
    assert got["variant"] == variant and got["steps"] == steps
    assert got["device"].startswith("cpu")
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=2e-3)
    avg = evals[0]["__average__"]
    assert evals[0].keys() == {"clip6", "clip7", "__average__"}
    np.testing.assert_allclose(got["psnr"], avg["psnr"], atol=0.01)
    np.testing.assert_allclose(got["ssim"], avg["ssim"], atol=1e-4)


def test_main_writes_every_variant(tmp_path, capsys):
    out = tmp_path / "ab.jsonl"
    assert qa.main(["--steps", "2", "--device", "cpu", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["variant"] for r in recs] == list(qa.VARIANTS)
    base = recs[0]["psnr"]
    for r in recs:
        assert r["steps"] == 2 and np.isfinite(r["psnr"]) and 0 < r["ssim"] <= 1
        assert r["dpsnr_vs_tpu_defaults"] == r["psnr"] - base
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if "dpsnr_vs_tpu_defaults" in line]
    assert printed == recs
    with pytest.raises(ValueError, match="unknown variants"):
        qa.main(["--variants", "tpu_defaults,espcn_wide", "--device", "cpu"])


def test_card_path_raises_without_a_gpu(monkeypatch, tmp_path, clips):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "ab.jsonl"
    with pytest.raises(RuntimeError, match="CUDA"):
        qa.main(["--steps", "1", "--out", str(out)])
    assert not out.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        qa.run_variant("tpu_defaults", qa.small_cfg(), clips, 1)

"""The port's serving-path quality tool
(``video_super_resolution_tpu_torch/tools/quality_serving.py``) against
the JAX package's ``tools/quality_serving.py``, on the CPU at small sizes:
the six variants' configs, the four clip sets, the ``oracle`` path against
the JAX package's ``evaluate_all`` on the same weights and clips (at the
composed-model tolerance of ``tests/test_torch_eval.py``), ``train``
(write, load, resume), the card paths without a GPU, and the verdict's
arithmetic.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.data.dataset import ClipDataset as JClipDataset
from video_super_resolution_tpu.evaluation import evaluate as jeval
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel
from video_super_resolution_tpu.training.step import make_eval_step as jax_eval_step

from video_super_resolution_tpu_torch.tools import quality_serving as qs
from video_super_resolution_tpu_torch.weights import from_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
            context_channels=(16, 16), depth_channels=8, depth_levels=2,
            fusion_channels=16, sr_channels=16, sr_blocks=2,
            warp_impl="gather")
TINY_SET = ["model.pyramid_channels=8,16", "model.flow_estimator_channels=16,16",
            "model.context_channels=16,16", "model.depth_channels=8",
            "model.depth_levels=2", "model.fusion_channels=16",
            "model.sr_channels=16", "model.sr_blocks=2", "data.crop_size=16"]
TRAIN_HW, EVAL_HW, FRAMES = (48, 64), (64, 128), 3
RUN_HW = (64, 96)            # LR 16x24: room for the crop of 16


@pytest.fixture(scope="module")
def jtool():
    """The JAX tool, loaded from its file (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_quality_serving", ROOT / "tools" / "quality_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jtool_small(jtool, monkeypatch):
    """The JAX tool with its clip sizes cut to the ones the port is given."""
    monkeypatch.setattr(jtool, "TRAIN_HR_H", TRAIN_HW[0])
    monkeypatch.setattr(jtool, "TRAIN_HR_W", TRAIN_HW[1])
    monkeypatch.setattr(jtool, "EVAL_HR_H", EVAL_HW[0])
    monkeypatch.setattr(jtool, "EVAL_HR_W", EVAL_HW[1])
    monkeypatch.setattr(jtool, "FRAMES", FRAMES)
    return jtool


@pytest.mark.parametrize("variant", qs.VARIANTS)
def test_production_cfg_matches_jax(jtool, variant):
    got = json.loads(qs.production_cfg(variant, 12000).to_json())
    want = json.loads(jtool.production_cfg(variant, 12000).to_json())
    assert got == want
    assert got["model"]["depth_res_divisor"] == (4 if variant in ("espcn_d4", "hard") else 2)


def test_production_cfg_rejects_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant"):
        qs.production_cfg("espcn_wide", 10)


@pytest.mark.parametrize("name,hw", [
    ("make_train_clips", TRAIN_HW), ("make_train_clips_hard", TRAIN_HW),
    ("make_eval_clips", EVAL_HW), ("make_eval_clips_hard", EVAL_HW)])
def test_clip_sets_match_jax(jtool_small, name, hw):
    got = getattr(qs, name)(*hw, frames=FRAMES)
    want = getattr(jtool_small, name)()
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == (FRAMES, *hw, 3) and got[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_clips_made_in_processes_are_the_same(monkeypatch):
    """Large clip sets are made one spawned process a clip: the same clips."""
    a = qs.make_eval_clips_hard(*EVAL_HW, frames=2)
    monkeypatch.setattr(qs, "PARALLEL_PIXELS", 0)
    b = qs.make_eval_clips_hard(*EVAL_HW, frames=2)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_oracle_path_matches_jax(jtool_small, tmp_path, monkeypatch):
    """The port's ``oracle`` record against the JAX tool's oracle route
    (``use_pallas=False``, gather warp, XLA convs and correlation) on the
    same weights (JAX's init, carried by ``from_jax_params``) and the same
    reduced hard eval clips."""
    monkeypatch.setenv("VSR_CONV_IMPL", "xla")
    monkeypatch.setenv("VSR_CORR_IMPL", "xla")
    jcfg = jtool_small.production_cfg("hard", 4)
    jm = JVSRModel(cfg=dataclasses.replace(jcfg.model, **TINY),
                   use_pallas=False, dtype=jnp.float32)
    params = jm.init(jax.random.key(0),
                     jnp.zeros((1, 3, 32, 32, 3), jnp.float32))["params"]
    cfg = qs.production_cfg("hard", 4)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **TINY))
    run = str(tmp_path / "run")
    qs.write_state(run, cfg, "hard", from_jax_params(params, cfg), step=4)

    got = qs.evaluate(run, ["oracle"], hr_size=EVAL_HW, frames=FRAMES)["oracle"]
    jds = JClipDataset(clips_hr=jtool_small.make_eval_clips_hard(),
                       window=3, scale=4, augment=False)
    want = jeval.evaluate_all(jax_eval_step(jm.apply), params, jds,
                              y_channel=True, border_crop=4, batch_windows=4)
    avg = want.pop("__average__")
    assert sorted(got["per_clip"]) == sorted(want) and len(want) == 6
    for k, w in want.items():
        g = got["per_clip"][k]
        assert g["frames"] == w["frames"] == FRAMES
        np.testing.assert_allclose(g["psnr"], w["psnr"], atol=0.01, err_msg=k)
        np.testing.assert_allclose(g["ssim"], w["ssim"], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["psnr"], avg["psnr"], atol=0.01)
    np.testing.assert_allclose(got["ssim"], avg["ssim"], atol=1e-4)
    assert got["lr_shape"] == [EVAL_HW[0] // 4, EVAL_HW[1] // 4]
    assert got["device"].startswith("cpu") and got["tf32"] is None
    assert json.loads((tmp_path / "run" / "eval_oracle.json").read_text()) == got


def _train(run, **kw):
    return qs.train("hard", 4, str(run), device="cpu", log_every=2,
                    overrides=TINY_SET, hr_size=RUN_HW, frames=FRAMES, **kw)


def test_train_writes_a_state_that_eval_loads_and_resumes_exactly(tmp_path):
    """4 steps in one call, and 2 + 2 in two (the second resumes from the
    step-2 checkpoint with the sample stream fast-forwarded): the same
    parameters, bit for bit. One CPU thread, as in the multi-process
    kill-and-resume test: with more, the CPU's reductions may round
    differently from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        whole = _train(tmp_path / "whole")
        first = _train(tmp_path / "split", until=2)
        second = _train(tmp_path / "split")
    finally:
        torch.set_num_threads(threads)
    assert (whole["start"], whole["end"]) == (0, 4)
    assert (first["start"], first["end"], second["start"], second["end"]) == (0, 2, 2, 4)
    cfg, run, a = qs.load_run(str(tmp_path / "whole"))
    _, run_b, b = qs.load_run(str(tmp_path / "split"))
    assert run["variant"] == "hard" and run["step"] == 4
    assert cfg.model.depth_res_divisor == 4 and cfg.train.compute_dtype == "bfloat16"
    assert [c["end"] for c in run_b["calls"]] == [2, 4]
    assert [r["step"] for r in run["curve"]] == [2, 4]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k

    recs = qs.evaluate(str(tmp_path / "whole"), ["oracle", "bf16_plain"],
                       hr_size=EVAL_HW, frames=FRAMES)
    for path, dtype in (("oracle", "float32"), ("bf16_plain", "bfloat16")):
        rec = recs[path]
        assert rec["step"] == 4 and rec["frames"] == 6 * FRAMES
        assert rec["compute_dtype"] == dtype and rec["device"].startswith("cpu")
        assert np.isfinite(rec["psnr"]) and 0 < rec["ssim"] <= 1
    with pytest.raises(ValueError, match="another config"):
        qs.train("hard", 8, str(tmp_path / "whole"), device="cpu",
                 overrides=TINY_SET, hr_size=RUN_HW, frames=FRAMES)


@pytest.mark.parametrize("call", ["eval serving", "eval f32_kernels", "train"])
def test_card_paths_raise_without_a_gpu(monkeypatch, tmp_path, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "train":
            qs.main(["train", "--variant", "hard", "--ckpt-dir", str(tmp_path)])
        else:
            qs.main(["eval", "--ckpt-dir", str(tmp_path), "--path",
                     call.split()[1]])
    assert not list(tmp_path.iterdir())


def _record(path, psnrs, variant="hard", step=10):
    per = {f"c{i}": {"psnr": p, "ssim": 0.8, "frames": 7}
           for i, p in enumerate(psnrs)}
    return {"variant": variant, "step": step, "path": path,
            "psnr": float(np.mean(psnrs)), "ssim": 0.8, "per_clip": per}


@pytest.mark.parametrize("serving,f32,variant,holds,regime,worst", [
    ([26.99, 30.02], [27.002, 29.998], "hard", True, True, 0.02),
    ([26.94, 30.0], [27.0, 30.0], "hard", False, True, 0.06),
    ([27.0, 30.0], [27.0, 30.051], "espcn", False, None, 0.051),
    ([27.0, float("nan")], [27.0, 30.0], "hard", False, True, float("nan")),
])
def test_verdict_arithmetic(tmp_path, serving, f32, variant, holds, regime, worst):
    oracle = [27.0, 30.0]
    records = {"oracle": _record("oracle", oracle, variant),
               "serving": _record("serving", serving, variant),
               "f32_kernels": _record("f32_kernels", f32, variant)}
    v = qs.verdict(records)
    assert v["holds"] is holds and v["regime"] is regime
    np.testing.assert_allclose(v["max_abs_delta_db"], worst, rtol=1e-9)
    for path, got in (("serving", serving), ("f32_kernels", f32)):
        d = v["deltas"][path]
        np.testing.assert_allclose([d["per_clip"]["c0"], d["per_clip"]["c1"]],
                                   np.subtract(got, oracle), rtol=1e-12)
        np.testing.assert_allclose(d["average"], np.mean(got) - np.mean(oracle),
                                   rtol=1e-12)
    for p, rec in records.items():
        (tmp_path / f"eval_{p}.json").write_text(json.dumps(rec))
    assert qs.main(["verdict", "--ckpt-dir", str(tmp_path)]) == (0 if holds else 1)
    assert json.loads((tmp_path / "verdict.json").read_text())["holds"] is holds


def test_verdict_regime_and_refusals():
    recs = {"oracle": _record("oracle", [24.9, 30.0]),
            "serving": _record("serving", [24.9, 30.0]),
            "f32_kernels": _record("f32_kernels", [24.9, 30.0])}
    assert qs.verdict(recs)["regime"] is False
    assert qs.verdict(recs)["holds"] is True
    with pytest.raises(ValueError, match="no eval record"):
        qs.verdict({k: v for k, v in recs.items() if k != "f32_kernels"})
    with pytest.raises(ValueError, match="different runs"):
        qs.verdict({**recs, "serving": _record("serving", [24.9, 30.0], step=11)})

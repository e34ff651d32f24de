"""The port's host-path, scaling and ceiling tools
(``video_super_resolution_tpu_torch/tools/bench_{dispatch,loader,scaling,
roofline}.py``) against the JAX package's ``tools/bench_*.py``, on the
CPU at TINY widths: the PNG clips, the dispatch record and its verdict
rule, the K-step control, the loader's stream choice, the scaling run
against the unsharded model and JAX's halo-free windows, the roofline's
FLOP/byte formulas and op outputs, and each tool's card path without a
GPU.

Tolerances: PNG pixels and the halo-free windows exact; the K-step
parameters rtol 1e-6 (the same f32 ops in the same order); the streamed
frames against the unsharded model rtol 1e-5, atol 1e-6 (f32, other batch
groupings); the roofline ops against JAX rtol 1e-5 (f32).
"""

import contextlib
import dataclasses
import importlib.util
import math
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from video_super_resolution_tpu.runtime import cache as jcache

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
    VSRConfig,
)
from video_super_resolution_tpu_torch.data import native_loader
from video_super_resolution_tpu_torch.data.dataset import sliding_window_indices
from video_super_resolution_tpu_torch.tools import bench_dispatch as bd
from video_super_resolution_tpu_torch.tools import bench_loader as bl
from video_super_resolution_tpu_torch.tools import bench_roofline as br
from video_super_resolution_tpu_torch.tools import bench_scaling as bs
from video_super_resolution_tpu_torch.training.state import create_train_state
from video_super_resolution_tpu_torch.training.step import (
    make_multi_train_step,
    make_train_step,
)
from test_parallel import TINY
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

ROOT = pathlib.Path(__file__).resolve().parent.parent
CLIPS = dict(n_clips=2, frames=3, h=48, w=64)
# the JAX dispatch record's keys at --k 2 (tools/bench_dispatch.py:80-187)
JAX_DISPATCH_KEYS = (
    "batch", "crop", "steps", "k", "device", "compile_device_side_s",
    "device_side_steps_per_s", "dispatch_only_steps_per_s",
    "host_driven_k1_steps_per_s", "loader",
    "host_driven_k1_compact_steps_per_s", "host_driven_k2_steps_per_s",
    "ratio_k1_vs_device", "ratio_dispatch_only_vs_device",
    "ratio_k1_compact_vs_device", "ratio_k2_vs_device", "verdict")
# the JAX loader record's keys (tools/bench_loader.py:117-134)
JAX_LOADER_KEYS = (
    "loader", "loader_batches_per_s", "loader_vs_device_side", "note",
    "host_driven_steps_per_s", "host_driven_frames_per_s",
    "device_side_steps_per_s_baseline", "ratio_vs_device_side", "batch",
    "crop", "warmup_s", "steps", "device", "clips")
JAX_SCALING_KEYS = ("time_axis", "frames", "sec", "frames_per_sec",
                    "weak_scaling_eff", "halo_overhead_eff", "compile_s")
TINY_SHAPES = {"matmul": (32,), "matmul_f32": (24,), "im2col": (64, 4, 8),
               "conv": ((1, 12, 16, 8, 8), (2, 9, 10, 3, 5)),
               "axpy": 1000, "transpose": (2, 6, 7, 5)}
TINY_OPS = ("matmul_32_f32", "matmul_24_f32", "matmul_im2col_64x36x8", "conv3x3_1x12x16x8-8",
            "k1_conv3x3_1x12x16x8-8", "conv3x3_2x9x10x3-5",
            "k1_conv3x3_2x9x10x3-5", "axpy_0.0038147MB_f32",
            "transpose_BHWC-BCHW")


def jax_roofline_counts():
    """(name, FLOP, bytes) of each op of the JAX tool at its shapes, by its
    own formulas (tools/bench_roofline.py:83-121), bf16 (2 bytes)."""
    out = [(f"matmul_{m}_bf16", 2 * m ** 3, 3 * m * m * 2)
           for m in (4096, 8192)]
    hw, cin, cout = 544 * 960, 64, 64
    out.append(("matmul_im2col_522240x576x64", 2 * hw * 9 * cin * cout,
                (hw * 9 * cin + hw * cout) * 2))
    for (b, h, w, ci, co) in [(1, 544, 960, 64, 64), (2, 544, 960, 131, 64),
                              (1, 540, 960, 64, 64), (2, 136, 240, 243, 128),
                              (3, 272, 480, 192, 64), (3, 272, 480, 3, 64)]:
        out.append((f"conv3x3_{b}x{h}x{w}x{ci}-{co}",
                    2 * 9 * ci * co * b * h * w,
                    (b * h * w * (ci + co) + 9 * ci * co) * 2))
    size = 64 * 1024 * 1024
    out.append(("axpy_256MB_f32", 2 * size, size * 8))
    out.append(("transpose_BHWC-BCHW", 0, 2 * 544 * 960 * 64 * 4))
    return out


JAX_ROOFLINE = jax_roofline_counts()


def tiny_cfg(**data) -> VSRConfig:
    model = ModelConfig(**{f.name: getattr(TINY, f.name)
                           for f in dataclasses.fields(ModelConfig)})
    return VSRConfig(model=model,
                     data=DataConfig(crop_size=8, batch_size=2, **data),
                     train=TrainConfig(compute_dtype="float32"))


# the tools' warm-up and loader-alone counts (the JAX tools') cut to a few
WARM, LOADER_BATCHES = 2, (1, 4)


@pytest.fixture(scope="module")
def jloader():
    """The JAX loader tool, loaded from its file (tools/ is not a package)
    with its compilation-cache setup made a no-op."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcache, "enable_cache", lambda *a, **k: None)
        spec = importlib.util.spec_from_file_location(
            "jax_bench_loader", ROOT / "tools" / "bench_loader.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    bl.make_png_clips(str(root), **CLIPS)
    return root


@pytest.fixture(scope="module")
def dispatch_rec(clip_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("dispatch") / "rec.json"
    seen = []

    @contextlib.contextmanager
    def around(name):
        seen.append(name)
        yield

    rec = bd.run(steps=3, k=2, root=str(clip_root), device="cpu",
                 cfg=tiny_cfg(), clips=CLIPS, out=str(out), around=around,
                 warm=WARM, emit=lambda s: None)
    return rec, out, seen


@pytest.fixture(scope="module")
def scaling():
    return bs.run([1, 2], 32, 64, 2, 2, "cpu", cfg=tiny_cfg(),
                  emit=lambda s: None)


def test_png_clips_equal_jax_pixels(jloader, clip_root, tmp_path):
    jloader.make_png_clips(str(tmp_path), **CLIPS)
    names = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*.png"))
    assert len(names) == CLIPS["n_clips"] * CLIPS["frames"]
    assert names == sorted(p.relative_to(clip_root)
                           for p in clip_root.rglob("*.png"))
    for name in names:
        got = np.asarray(Image.open(clip_root / name))
        want = np.asarray(Image.open(tmp_path / name))
        assert got.shape == (CLIPS["h"], CLIPS["w"], 3)
        np.testing.assert_array_equal(got, want, err_msg=str(name))


def test_dispatch_record_has_jax_keys(dispatch_rec):
    """Every JAX key (``first_call_s`` in place of the scan's compile
    time) plus ``device_side_method``; every number finite and > 0; the
    file holds the record; the controls ran in JAX's order."""
    rec, out, seen = dispatch_rec
    want = (set(JAX_DISPATCH_KEYS) - {"compile_device_side_s"}) | {
        "first_call_s", "device_side_method"}
    assert want <= set(rec)
    assert rec["device_side_method"] == "profiled busy"
    assert rec["device"] == "cpu" and rec["loader"] in bl.LOADERS
    for k, v in rec.items():
        if not isinstance(v, str):
            assert math.isfinite(v) and v > 0, k
    assert bd.json.loads(out.read_text()) == rec
    assert seen == ["device_side", "dispatch_only", "host_driven_k1",
                    "host_driven_k1_compact", "host_driven_k2"]


def test_multi_step_equals_single_steps():
    """The K control's ``make_multi_train_step`` on a stack of two batches
    and two single steps on them give equal parameters."""
    cfg = tiny_cfg()
    rng = np.random.default_rng(3)
    batches = [{"lr": rng.random((2, 3, 8, 8, 3)).astype(np.float32),
                "hr": rng.random((2, 32, 32, 3)).astype(np.float32)}
               for _ in range(2)]
    multi = create_train_state(cfg, "cpu")
    single = create_train_state(cfg, "cpu")
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    make_multi_train_step(cfg.train.charbonnier_eps)(multi, stacked)
    step = make_train_step(cfg.train.charbonnier_eps)
    for b in batches:
        step(single, b)
    assert multi.step == single.step == 2
    got, want = multi.model.state_dict(), single.model.state_dict()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0,
                                   msg=k)


@pytest.mark.parametrize("dispatch_only,k1,kind", [
    (10.0, 7.0, "launch-bound"), (10.0, 6.4, "transfer-bound"),
    (6.5, 20.0, "transfer-bound")])
def test_verdict_follows_jax_rule(dispatch_only, k1, kind):
    jax_launch_bound = abs(dispatch_only - k1) < 0.35 * max(dispatch_only, k1)
    assert jax_launch_bound == (kind == "launch-bound")
    assert bd.verdict(dispatch_only, k1).startswith(kind + ":")
    assert "tunnel" not in bd.verdict(dispatch_only, k1)


def test_union_of_intervals():
    def ev(start, end):
        return types.SimpleNamespace(
            time_range=types.SimpleNamespace(start=start, end=end))
    spans = [(20, 25), (0, 10), (5, 15), (12, 14)]
    assert bd.union_us([ev(*sp) for sp in spans]) == 20
    assert bd.union_us([]) == 0


def test_loader_native_raises_naming_missing(monkeypatch, clip_root):
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(native_loader, "missing", lambda: ("g++",))
    with pytest.raises(RuntimeError, match="native loader not engaged "
                       r"\(python\).*g\+\+"):
        bl.run("native", 1, 1, str(clip_root), "cpu", cfg=tiny_cfg(),
               clips=CLIPS, loader_batches=LOADER_BATCHES, emit=lambda s: None)


@pytest.mark.parametrize("loader", bl.LOADERS)
def test_loader_records(loader, clip_root, tmp_path):
    """Each loader as asked, the JAX record's keys (the in-process
    ``device_side_steps_per_s`` in place of the TPU baseline), numbers
    finite and > 0."""
    if loader == "native" and not native_loader.available():
        pytest.skip(f"native loader not buildable: {native_loader.missing()}")
    out = tmp_path / "loader.json"
    rec = bl.run(loader, 2, 3, str(clip_root), "cpu", cfg=tiny_cfg(),
                 clips=CLIPS, out=str(out), loader_batches=LOADER_BATCHES,
                 emit=lambda s: None)
    assert rec["loader"] == loader
    want = (set(JAX_LOADER_KEYS) - {"device_side_steps_per_s_baseline"}) | {
        "device_side_steps_per_s"}
    assert set(rec) == want
    for k, v in rec.items():
        if not isinstance(v, str):
            assert math.isfinite(v) and v > 0, k
    assert bl.json.loads(out.read_text()) == rec


@pytest.mark.parametrize("n", [1, 2])
def test_streamed_frames_equal_unsharded_model(scaling, n):
    frames, out = scaling[1][n]
    cfg = tiny_cfg()
    model = api.build_model(cfg, "cpu", seed=0)
    t = len(frames)
    windows = np.stack([frames[sliding_window_indices(t, c, 3)]
                        for c in range(t)])
    with torch.no_grad():
        want = model(torch.from_numpy(windows)).numpy()
    assert out.shape == (t, 128, 256, 3)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,rank", [(1, 0), (2, 0), (2, 1)])
def test_no_halo_windows_equal_jax_construction(scaling, n, rank):
    """The JAX tool's expression (tools/bench_scaling.py:92-93) on the
    frames the tool drew for N, this rank's slice of its time sharding."""
    frames, fpd, window = scaling[1][n][0], 2, 3
    jax_win = np.stack([np.roll(np.asarray(frames), -i, 0)[: fpd * n]
                        for i in range(window)], 1)
    got = bs.no_halo_windows(frames, window, fpd, n, rank)
    np.testing.assert_array_equal(got, jax_win[rank * fpd:(rank + 1) * fpd])


def test_scaling_record(scaling):
    payload, outputs = scaling
    assert {"note", "host_cores", "shape", "results", "gpus", "backend",
            "device"} <= set(payload)
    assert payload["backend"] == "gloo" and payload["device"] == "cpu"
    assert payload["shape"] == [2, 32, 64]
    rng = np.random.default_rng(0)       # the JAX tool's draws, in turn
    for rec in payload["results"]:
        n = rec["time_axis"]
        assert set(JAX_SCALING_KEYS) <= set(rec)
        assert rec["frames"] == 2 * n and len(rec["launches"]) == n
        # the frame halo is the one collective: none along an axis of one
        assert [c[0] for c in rec["collectives"]] == (
            ["exchange"] if n > 1 else [])
        assert rec["weak_scaling_eff"] == payload["results"][0]["sec"] / rec["sec"]
        for k in JAX_SCALING_KEYS:
            assert math.isfinite(rec[k]) and rec[k] > 0, k
        q = rec["halo_overhead_eff_quartiles"]
        assert len(q) == 3 and 0 < q[0] <= q[1] <= q[2]
        np.testing.assert_array_equal(
            outputs[n][0], rng.random((2 * n, 32, 64, 3)).astype(np.float32))


@pytest.mark.parametrize("name,flops,nbytes", JAX_ROOFLINE,
                         ids=[r[0] for r in JAX_ROOFLINE])
def test_roofline_counts_equal_jax_formulas(name, flops, nbytes):
    """Pure arithmetic: no input is made. A conv's ``k1_`` row counts
    what the conv does; the additions are the ``k1_`` rows and the f32
    matmul."""
    ops = {op.name: op for op in br.roofline_ops("cpu")}
    assert (ops[name].flops, ops[name].nbytes) == (flops, nbytes)
    if name.startswith("conv3x3"):
        k1 = ops["k1_" + name]
        assert (k1.flops, k1.nbytes) == (flops, nbytes)
    jax_names = [r[0] for r in JAX_ROOFLINE]
    added = [n for n in ops if n.startswith("k1_") or n == "matmul_8192_f32"]
    assert [n for n in ops if n not in added] == jax_names
    assert len(added) == 7 and ops["matmul_8192_f32"].flops == 2 * 8192 ** 3


def _jax_op(name, args):
    a = [np.asarray(t.float()) for t in args]
    if name.startswith("matmul"):
        return jnp.dot(a[0], a[1])
    if name.startswith("conv3x3"):
        return lax.conv_general_dilated(
            a[0], a[1].transpose(2, 3, 1, 0), (1, 1), ((1, 1), (1, 1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if name.startswith("axpy"):
        return a[0] * 1.5 + 2.0
    return jnp.transpose(a[0], (0, 3, 1, 2))


@pytest.mark.parametrize("name", TINY_OPS)
def test_roofline_ops_equal_jax(name):
    """Each op at tiny shapes, f32, against its JAX counterpart on the same
    inputs; a ``k1_`` row against ``F.conv2d`` (its conv row)."""
    ops = {op.name: op for op in br.roofline_ops("cpu", TINY_SHAPES,
                                                 torch.float32)}
    assert tuple(ops) == TINY_OPS
    op = ops[name]
    args = op.make_args()
    got = op.fn(*args)
    if name.startswith("k1_"):
        ref = ops[name[3:]]
        want = ref.fn(*ref.make_args()).numpy()
    else:
        assert all(t.dtype == torch.float32 for t in args)
        want = np.asarray(_jax_op(name, args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tool", [bd, bl, bs, br],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_card_path_raises_without_gpu(monkeypatch, tool, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out", str(tmp_path / "out")]
    if tool in (bd, bl):
        argv += ["--root", str(tmp_path / "clips")]
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(argv)
    assert not (tmp_path / "out").exists()

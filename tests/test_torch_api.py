"""The PyTorch port's boundaries: what it imports, where its entry points
run, and how weights cross from the JAX package's flax param tree; the
serving entry's ``record_function`` ranges and counters."""

import ast
import ctypes
import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.config import serving_config as jax_serving_config
from video_super_resolution_tpu.models.vsr import VSRModel as JVSRModel

from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    VSRConfig,
    serving_config,
)
from video_super_resolution_tpu_torch.data.dataset import sliding_window_indices
from video_super_resolution_tpu_torch.models.common import init_params
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.weights import from_jax_params, to_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

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


HOST_SOURCES = [ROOT / "video_super_resolution_tpu_torch" / "csrc" / name
                for name in ("vsr_dataio.cc", "png_decode.h", "vsr_hostmem.cc")]


@pytest.mark.parametrize("path", HOST_SOURCES, ids=lambda p: p.name)
def test_native_data_path_includes_only_std_and_its_own_headers(path):
    """The port's C++ data path (``data/native_loader.py`` builds it with
    g++), and the clip recycler (``runtime/hostmem.py``), include C++ standard headers (``<name>``, no extension) and its
    own headers beside it: no libpng, no zlib, nothing of the JAX
    package's ``native/``."""
    includes = re.findall(r'#\s*include\s*([<"])([^>"]+)', path.read_text())
    assert includes
    for kind, name in includes:
        if kind == "<":
            assert "." not in name, f"{path.name} includes <{name}>"
        else:
            assert (path.parent / name).is_file(), f"{path.name} includes {name}"


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


def _smooth_frames(h, w, shifts):
    """A smooth pattern sampled at a (dx, dy) shift per frame: small,
    smooth motion, so that the flows stay inside the tiled warp's budget
    (JAX's FlowNet warps with ``warp_impl="tiled"``)."""
    y = np.arange(h, dtype=np.float32)[:, None, None]
    x = np.arange(w, dtype=np.float32)[None, :, None]
    c = np.arange(3, dtype=np.float32)[None, None, :]
    return np.stack([0.5 + 0.4 * np.sin(0.3 * (x + dx) + 0.7 * c)
                     * np.cos(0.2 * (y + dy)) for dx, dy in shifts]
                    ).astype(np.float32)


@pytest.mark.parametrize("finest", [1, 0])
def test_estimate_and_align_matches_jax(finest):
    """``api.estimate_and_align`` against the JAX package's, with JAX's
    ``init_flow_params`` loaded strictly: the standalone flow net is built
    at finest level 1 whatever ``flow_finest_level`` says, as JAX builds
    it. Flow-net tolerance (rtol 2e-3, atol 2e-4); 32x48, below 2^17
    pixels."""
    from video_super_resolution_tpu import api as japi
    from video_super_resolution_tpu.config import ModelConfig as JModelConfig
    from video_super_resolution_tpu.config import VSRConfig as JVSRConfig

    from video_super_resolution_tpu_torch.config import ModelConfig

    small = dict(pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
                 context_channels=(16, 16), flow_finest_level=finest)
    jcfg = JVSRConfig(model=JModelConfig(**small))
    params = jax.tree.map(np.asarray, japi.init_flow_params(jcfg, seed=0))
    net = api.build_flow_net(VSRConfig(model=ModelConfig(**small)), "cpu")
    net.load_state_dict(from_jax_params(params, net), strict=True)

    frames = _smooth_frames(32, 48, [(0.0, 0.0), (0.6, -0.4), (-0.5, 0.3)])
    ref, nbrs = frames[None, 0], frames[None, 1:]
    want_f, want_w = japi.estimate_and_align(params, jnp.asarray(ref),
                                             jnp.asarray(nbrs), jcfg)
    got_f, got_w = api.estimate_and_align(net, torch.from_numpy(ref),
                                          torch.from_numpy(nbrs))
    assert got_f.shape == (1, 2, 32, 48, 2)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                               rtol=2e-3, atol=2e-4)


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


TINY = dict(pyramid_channels=(8, 16, 32), max_displacement=2,
            flow_estimator_channels=(16, 12), context_channels=(16, 12),
            depth_channels=8, depth_levels=2, fusion_channels=16,
            sr_channels=16, sr_blocks=2, depth_res_divisor=4)
# the serving entry's ranges: how often each runs, and its parent
CLIP_SPANS = {"upscale_clip": ("clip", None),
              "upscale_clip.gather": ("frame", "upscale_clip"),
              "eval_step.upload": ("frame", "upscale_clip"),
              "eval_step.forward": ("frame", "upscale_clip"),
              "upscale_clip.stage": ("frame", "upscale_clip"),
              "upscale_clip.copy_back": ("frame", "upscale_clip")}
FRAME_ORDER = ["upscale_clip.gather", "eval_step.upload",
               "eval_step.forward", "upscale_clip.stage"]


@pytest.fixture(scope="module")
def tiny_model():
    cfg = VSRConfig(model=ModelConfig(**TINY),
                    train=TrainConfig(compute_dtype="float32"))
    return api.build_model(cfg, device="cpu", seed=4)


def clip_frames(t, h=16, w=24):
    return np.random.default_rng(t).random((t, h, w, 3)).astype(np.float32)


def profiled(fn, *args):
    """fn(*args) under torch.profiler on the CPU: (its result, its host
    events by name, each as sorted (start, end) pairs)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    by = {}
    for e in prof.events():
        by.setdefault(e.name, []).append((e.time_range.start,
                                          e.time_range.end))
    return out, {k: sorted(v) for k, v in by.items()}


@pytest.mark.parametrize("t", [3, 5])
def test_upscale_clip_spans_nest_and_count(tiny_model, t):
    """One ``upscale_clip`` range a clip holds, a frame each and in this
    order, the gather, the upload, the forward and the stage; each frame's
    copy back follows its own forward, and the next frame's where there is
    one; no range stacks the clip. The output is the unprofiled call's,
    bit for bit."""
    frames = clip_frames(t)
    plain = api.upscale_clip(tiny_model, frames)
    out, spans = profiled(api.upscale_clip, tiny_model, frames)
    assert out.dtype == plain.dtype and np.array_equal(out, plain)
    for name, (once_per, _) in CLIP_SPANS.items():
        assert len(spans.get(name, [])) == (1 if once_per == "clip" else t), name
    assert "upscale_clip.stack" not in spans
    (clip,) = spans["upscale_clip"]
    for name, (_, parent) in CLIP_SPANS.items():
        if parent:
            assert all(clip[0] <= s <= e <= clip[1] for s, e in spans[name]), name
    want = []
    for c in range(t):
        want += FRAME_ORDER + ["upscale_clip.copy_back"] * (c > 0)
    want.append("upscale_clip.copy_back")
    seq = sorted((s, e, n) for n in CLIP_SPANS if n != "upscale_clip"
                 for s, e in spans[n])
    assert [n for _, _, n in seq] == want
    assert all(a[1] <= b[0] for a, b in zip(seq, seq[1:]))
    fwd, back = spans["eval_step.forward"], spans["upscale_clip.copy_back"]
    for c in range(t):
        assert back[c][0] >= fwd[min(c + 1, t - 1)][1]


@pytest.mark.parametrize("edge_mode", ["replicate", "reflect"])
@pytest.mark.parametrize("t", [1, 2, 3, 5])
def test_upscale_clip_is_the_per_frame_eval_step_stack(tiny_model, t,
                                                       edge_mode):
    """The clip is ``eval_step`` of each frame's window, stacked, bit for
    bit: a fresh, writeable, C-contiguous f32 array that a later call
    leaves as it is."""
    frames = clip_frames(t)
    want = np.stack([api.eval_step(tiny_model, torch.from_numpy(frames[
        sliding_window_indices(t, c, tiny_model.cfg.window, edge_mode)][None])
    )[0].numpy() for c in range(t)])
    out = api.upscale_clip(tiny_model, frames, edge_mode)
    assert out.dtype == np.float32 and out.shape == want.shape
    assert out.flags.c_contiguous and out.flags.writeable and out.flags.owndata
    assert np.array_equal(out, want)
    kept = out.copy()
    again = api.upscale_clip(tiny_model, clip_frames(t + 1, 12, 20), edge_mode)
    assert not np.shares_memory(out, again) and np.array_equal(out, kept)


def test_eval_step_spans_hold_the_model(tiny_model):
    """A direct ``eval_step`` call runs one upload and one forward range,
    the model's own ranges inside the forward."""
    lr = torch.from_numpy(clip_frames(3)[None])
    out, spans = profiled(api.eval_step, tiny_model, lr)
    assert torch.equal(out, api.eval_step(tiny_model, lr))
    assert len(spans["eval_step.upload"]) == len(spans["eval_step.forward"]) == 1
    assert "upscale_clip" not in spans
    (up,), (fwd,) = spans["eval_step.upload"], spans["eval_step.forward"]
    assert up[1] <= fwd[0]
    for stage in ("flow", "depth", "fusion", "sr"):
        assert all(fwd[0] <= s <= e <= fwd[1] for s, e in spans[stage]), stage


@pytest.mark.parametrize("t", [3, 5])
@pytest.mark.parametrize("under_profiler", [False, True])
def test_upscale_clip_counts_frames_and_bytes(tiny_model, t, under_profiler):
    h, w = 16, 24
    entry = api.upscale_clip
    frames, bytes_back, staged = entry.frames, entry.bytes_back, entry.frames_staged
    if under_profiler:
        out, _ = profiled(api.upscale_clip, tiny_model, clip_frames(t, h, w))
    else:
        out = api.upscale_clip(tiny_model, clip_frames(t, h, w))
    assert out.shape == (t, 4 * h, 4 * w, 3)
    assert api.upscale_clip.frames - frames == t
    assert api.upscale_clip.bytes_back - bytes_back == t * 16 * h * w * 3 * 4
    assert api.upscale_clip.frames_staged == staged     # no pinned buffer on the CPU


def test_upscale_clip_frees_each_frame_before_the_next_forward(tiny_model,
                                                               monkeypatch):
    """The entry holds no frame's output or window across the next
    frame's forward: device memory peaks as without its ranges."""
    import weakref

    real, held = api.eval_step, []

    def eval_step(model, lr):
        assert all(r() is None for r in held)
        out = real(model, lr)
        held[:] = [weakref.ref(lr), weakref.ref(out)]
        return out

    monkeypatch.setattr(api, "eval_step", eval_step)
    out = api.upscale_clip(tiny_model, clip_frames(4))
    assert out.shape[0] == 4 and all(r() is None for r in held)


# ------------------------------------------------ the recycled clip memory

class Recycler:
    """``runtime/hostmem.py`` whose ``stats`` count the blocks lent and the
    hits since the test started: arrays of earlier tests may still hold
    blocks, and the hits run from the process's start."""

    def __init__(self, hostmem):
        self.hostmem = hostmem
        self.base = hostmem.stats()

    def __getattr__(self, name):
        return getattr(self.hostmem, name)

    def stats(self):
        idle, lent, hits = self.hostmem.stats()
        return idle, lent - self.base[1], hits - self.base[2]


@pytest.fixture
def recycler():
    """The recycler with no idle block and its floor at 0, so the tiny
    clips' blocks are kept; both restored after."""
    from video_super_resolution_tpu_torch.runtime import hostmem

    floor = ctypes.c_size_t.in_dll(hostmem.load(), "vsr_hostmem_floor")
    saved = floor.value
    hostmem.release()
    floor.value = 0
    yield Recycler(hostmem)
    floor.value = saved
    hostmem.release()


def eval_step_stack(model, frames, edge_mode="replicate"):
    t = len(frames)
    return np.stack([api.eval_step(model, torch.from_numpy(frames[
        sliding_window_indices(t, c, model.cfg.window, edge_mode)][None])
    )[0].numpy() for c in range(t)])


def handler_name(a):
    try:
        from numpy._core.multiarray import get_handler_name
    except ImportError:                         # numpy < 2
        from numpy.core.multiarray import get_handler_name
    return get_handler_name(a)


@pytest.mark.parametrize("t", [1, 4])
def test_a_clip_after_a_dropped_one_is_recycled(tiny_model, recycler, t):
    """Once the caller drops a clip, the next clip that fits takes its
    block: ``frames_recycled`` rises by its frames, and it is still a
    fresh, writeable, C-contiguous f32 array that owns its data, equal to
    the per-frame ``eval_step`` stack bit for bit."""
    first = api.upscale_clip(tiny_model, clip_frames(t))
    address, nbytes = first.ctypes.data, first.nbytes
    first.fill(np.nan)              # the next clip has to overwrite it all
    del first
    assert recycler.stats()[:2] == (nbytes, 0)
    frames = clip_frames(t + 7)[:t]
    before = api.upscale_clip.frames_recycled
    out = api.upscale_clip(tiny_model, frames)
    assert api.upscale_clip.frames_recycled - before == t
    assert out.ctypes.data == address and recycler.stats()[:2] == (0, 1)
    assert out.dtype == np.float32 and out.shape == (t, 64, 96, 3)
    assert out.flags.c_contiguous and out.flags.writeable and out.flags.owndata
    assert np.array_equal(out, eval_step_stack(tiny_model, frames))


HOLDERS = {"clip": lambda a: a, "view": lambda a: a[1:],
           "torch": torch.from_numpy, "memoryview": memoryview}


@pytest.mark.parametrize("holder", list(HOLDERS))
def test_a_live_clip_keeps_its_block(tiny_model, recycler, holder):
    """A clip, a view of it or an export of it that is still alive keeps
    the clip's block out of the cache: the next clip gets other memory,
    and the held bytes stay as they were. Once the holder is dropped, the
    block is recycled."""
    first = api.upscale_clip(tiny_model, clip_frames(3))
    held, kept = HOLDERS[holder](first), first[1:].copy()
    del first
    assert recycler.stats()[0] == 0
    before = api.upscale_clip.frames_recycled
    second = api.upscale_clip(tiny_model, clip_frames(3, 16, 24)[::-1].copy())
    assert api.upscale_clip.frames_recycled == before
    held_array = np.asarray(held)
    assert not np.shares_memory(second, held_array)
    assert np.array_equal(held_array[-2:], kept)
    del held, held_array
    assert recycler.stats()[0] == second.nbytes
    del second
    api.upscale_clip(tiny_model, clip_frames(2))
    assert api.upscale_clip.frames_recycled - before == 2


def test_a_longer_clip_gets_fresh_memory_and_its_block_is_kept(tiny_model,
                                                                recycler):
    """A clip longer than the idle block gets fresh memory; when it is
    dropped, its larger block replaces the idle one."""
    before = api.upscale_clip.frames_recycled
    short = api.upscale_clip(tiny_model, clip_frames(2))
    small = short.nbytes
    del short
    long_ = api.upscale_clip(tiny_model, clip_frames(5))
    assert api.upscale_clip.frames_recycled == before
    assert recycler.stats()[0] == small
    del long_
    assert recycler.stats()[0] == 5 * small // 2
    api.upscale_clip(tiny_model, clip_frames(3))
    assert api.upscale_clip.frames_recycled - before == 3


@pytest.mark.parametrize("floor", ["lowered", "default"])
def test_at_most_one_block_is_idle(recycler, floor):
    """Of the blocks freed, only the largest is kept, and only at or over
    the floor (64 MiB unless lowered): after three are freed, one request
    takes the idle block and the next gets fresh memory. ``empty`` leaves
    numpy's default handler on every other array."""
    unit = 1 << 20
    if floor == "default":
        ctypes.c_size_t.in_dll(recycler.load(), "vsr_hostmem_floor").value = 64 * unit
    blocks = [recycler.empty((n * unit,), np.uint8)[0] for n in (48, 80, 72)]
    assert recycler.stats()[:2] == (0, 3)
    assert handler_name(blocks[0]) == "vsr_clip_recycler"
    assert handler_name(np.empty(3)) == handler_name(np.ones((2, 2)))
    assert handler_name(np.empty(3)) == "default_allocator"
    del blocks[:]
    assert recycler.stats()[:2] == (80 * unit, 0)
    a, hit_a = recycler.empty((16 * unit,), np.uint8)
    b, hit_b = recycler.empty((16 * unit,), np.uint8)
    assert (hit_a, hit_b) == (True, False)
    assert recycler.stats()[:2] == (0, 2)
    del a, b
    # a held the 80 MiB block, which is kept again; b's 16 MiB is not
    assert recycler.stats()[0] == 80 * unit


def test_zeros_and_resize_through_the_recycler(recycler):
    """numpy's calloc through the handler zeroes a recycled block; its
    realloc keeps the bytes, in place when the block has room, and the
    block's capacity follows it to the idle slot."""
    n = 1 << 20
    a, _ = recycler.empty((4 * n,), np.uint8)
    a.fill(7)
    del a
    previous = recycler._set_handler(recycler._capsule)
    try:
        z = np.zeros((n,), np.uint8)            # calloc: takes the idle block
    finally:
        recycler._set_handler(previous)
    assert recycler.stats()[1:] == (1, 1) and not z.any()
    z[:] = 3
    address = z.ctypes.data
    z.resize((2 * n,), refcheck=False)          # realloc within the block
    assert z.ctypes.data == address and (z[:n] == 3).all()
    z.resize((8 * n,), refcheck=False)          # realloc past it
    assert (z[:n] == 3).all() and recycler.stats()[:2] == (0, 1)
    del z
    assert recycler.stats()[:2] == (8 * n, 0)


def test_threads_never_share_a_live_block(recycler):
    """More threads than cores allocate, fill, check and drop blocks
    through the recycler at a short switch interval: no live array's bytes
    are another's, and at the end no block is lent and at most one idle."""
    import os
    import sys
    import threading

    n, rounds = 1 << 20, 40
    workers = 2 * (os.cpu_count() or 1)
    bad = []

    def work(tag):
        for _ in range(rounds):
            a, _ = recycler.empty((n,), np.uint8)
            a.fill(tag)
            if not (a == tag).all():
                bad.append(tag)
            del a

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i + 1,))
                   for i in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not bad
    idle, lent, _ = recycler.stats()
    assert lent == 0 and idle == n


EXIT_WITH_A_LIVE_CLIP = """
import numpy as np, torch
from video_super_resolution_tpu_torch import api
from video_super_resolution_tpu_torch.config import ModelConfig, TrainConfig, VSRConfig
cfg = VSRConfig(model=ModelConfig(**{tiny!r}),
                train=TrainConfig(compute_dtype="float32"))
model = api.build_model(cfg, device="cpu", seed=4)
frames = np.random.default_rng(0).random((2, 16, 24, 3)).astype(np.float32)
dropped = api.upscale_clip(model, frames)
del dropped
clip = api.upscale_clip(model, frames)
view = clip[1:]
print(clip.shape)
"""


def test_exit_with_a_live_clip_is_clean(tmp_path):
    """A process that exits while a clip (and a view of it) is alive exits
    0 and writes nothing to stderr: the handler's name and functions
    outlive every array they free."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-c",
                           EXIT_WITH_A_LIVE_CLIP.format(tiny=TINY)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stderr == "", proc.stderr
    assert proc.stdout.strip() == "(2, 64, 96, 3)"


# ------------------------------------------- the forward from CUDA graphs

def graph_counts():
    e = api.eval_step
    return np.array([e.calls, e.replays, e.captures])


@pytest.mark.parametrize("entry", ["eval_step", "upscale_clip"])
def test_a_cpu_model_never_captures(tiny_model, entry):
    """On the CPU every call runs the eager forward: ``eval_step`` counts
    its calls, never a replay or a capture, and its output is the model's
    clamped, whatever the call's place in a run of equal keys."""
    from video_super_resolution_tpu_torch.models import graphs

    frames = clip_frames(4)
    before = graph_counts()
    if entry == "eval_step":
        lr = torch.from_numpy(frames[:3][None])
        want = api.upscale_window(tiny_model, lr).clamp(0.0, 1.0)
        for _ in range(3):
            assert torch.equal(api.eval_step(tiny_model, lr), want)
        calls = 3
    else:
        want = np.stack([api.upscale_window(tiny_model, torch.from_numpy(
            frames[sliding_window_indices(4, c, 3, "replicate")][None])
        )[0].clamp(0.0, 1.0).numpy() for c in range(4)])
        for _ in range(2):
            assert np.array_equal(api.upscale_clip(tiny_model, frames), want)
        calls = 8
    assert (graph_counts() - before).tolist() == [calls, 0, 0]
    assert graphs.graphed(tiny_model).set is None
    api.release_graphs(tiny_model)          # nothing to free: no error


def test_graph_key_follows_what_the_forward_reads(tiny_model):
    """The key a CUDA call would carry: equal for equal calls; another for
    another shape or dtype, after an in-place weight update or with the
    TF32 switch flipped; none with grad enabled on parameters that require
    it, nor off CUDA."""
    from video_super_resolution_tpu_torch.models.graphs import GraphedForward

    cuda = torch.device("cuda")
    lr = torch.zeros((1, 3, 16, 24, 3))
    with torch.no_grad():
        key = GraphedForward.key(tiny_model, lr, cuda)
        assert key is not None and key == GraphedForward.key(
            tiny_model, lr.clone(), cuda)
        assert GraphedForward.key(tiny_model, lr[:, :, :8], cuda) != key
        assert GraphedForward.key(tiny_model, lr.double(), cuda) != key
        assert GraphedForward.key(tiny_model, lr, torch.device("cpu")) is None
        tf32 = torch.backends.cudnn.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = not tf32
            assert GraphedForward.key(tiny_model, lr, cuda) != key
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        w = tiny_model.sr_head.Conv_0.weight
        w.mul_(1.0)
        bumped = GraphedForward.key(tiny_model, lr, cuda)
        assert bumped != key and bumped == GraphedForward.key(tiny_model, lr, cuda)
    with torch.enable_grad():
        assert GraphedForward.key(tiny_model, lr, cuda) is None
        tiny_model.requires_grad_(False)
        try:
            assert GraphedForward.key(tiny_model, lr, cuda) == bumped
        finally:
            tiny_model.requires_grad_(True)

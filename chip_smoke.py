"""On-GPU smoke run of the PyTorch port (video_super_resolution_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); it imports neither JAX nor
the JAX package. Phases, each of which fails the run on error:

1. build: compile the three CUDA kernels from ``csrc/`` (nvcc, sm_90a),
   print the build seconds, each kernel's registers and spills from ptxas
   (flagging any spill), and the card's name and power limit;
2. serving forward: ``serving_config()`` with seeded random weights, bf16,
   one (1, 3, 540, 960, 3) window through ``api.eval_step`` ->
   (1, 2160, 3840, 3); every launch counter is set to 0 just before and
   read just after, and each kernel must have launched; the output must be
   finite and in [0, 1]; the shapes each kernel was called with are
   recorded;
3. kernels: at every argument spec the forward gave each kernel (shape,
   dtype and options, e.g. correlation's fused slope and output dtype), the
   kernel is held against its plain PyTorch version, in f32 (TF32 off;
   rtol 1e-4, atol 1e-4) and in bf16 (rtol 2e-2, atol 2e-2), and timed
   beside the plain version, the same function by PyTorch library calls
   where there are such, and the least time the card could take (bytes /
   3.35 TB/s vs FLOP / peak rate). The library route computes the
   kernel's whole function: for conv3x3 ``F.conv2d`` with the bias,
   residual, LeakyReLU and shuffle as eager ops
   (``tools/bench_conv.py:conv3x3_library``), for the warp
   ``F.grid_sample`` on an f32 grid (``tools/bench_warp.py:warp_library``).
   Two times are printed for each: "host-incl." is CUDA events around
   back-to-back wrapper calls, which at small shapes measures the
   wrapper's host path;
   "device" is CUDA events around the replay of a CUDA graph that captured
   GRAPH_CALLS calls, which runs the same kernels with no host work
   between them (warm L2 in both). The per-forward totals of the
   ``{"kernels": ...}`` line (ms, plain_ms, library_ms) are device times.
   For conv3x3 also its tile plan (staging route, pixel tile, split-K
   factor) and its rate as a share of the peak;
4. throughput: median and p75 per-forward time of 40 back-to-back bf16
   forwards (CUDA events), frames/s, peak device memory; then
   ``[bench]``: the headline bench as a user types it, ``python -m
   video_super_resolution_tpu_torch.bench`` and ``... --train`` at their
   defaults (540x960, frames 16), each in its own process with the
   kernels' build cache already warm: each last line's metric
   (``frames_per_sec_per_chip_540x960_to_x4``,
   ``train_steps_per_sec_b4_crop64``) and unit, a finite value > 0,
   ``device`` the card's nvidia-smi name and power limit, the serving
   ``out_shape`` (1, 2160, 3840, 3), and each line's launches a frame or
   a step, phase 2's (conv3x3 59, correlation 4, warp 4); the bench's 1000 / value printed
   beside the throughput median above; then the two profile tools at
   ``VSRConfig()`` 540x960 (``[profile-model]``: first, before any
   profile has run in the process, the host cost of a ``record_function``
   range and the forward with and without the four newest ranges in turns; every stage of ``tools/profile_model.py``, each
   JAX stage name present, each ms finite and > 0; the forward and a
   launch's host cost again after the profiles. ``[profile-prefix]``:
   ``tools/profile_prefix.py``, each JAX prefix name present, the stage
   deltas plus glue within 1 % of the trace's device busy); then the
   probe and ``[png]`` (below) and the host-path, scaling and ceiling
   tools at ``VSRConfig()``:
   - ``[dispatch]``: ``tools/bench_dispatch.py`` at ``--steps 20 --k 4``
     on its PNG clips: every control finite and > 0, each launching every
     kernel (counts set to 0 before each control, read after); the fed
     controls on the native loader (the record's ``loader``);
   - ``[loader]``: ``tools/bench_loader.py`` at ``--warmup 10 --steps
     20``, three runs, each record's ``loader`` the one asked for:
     ``--loader native`` (frame cache on; the loader alone over
     LOADER_ALONE_NATIVE batches, so the cache is warm), the ``--loader
     python`` control, and ``--loader native`` cold
     (``VSR_LOADER_CACHE_MB=0`` set before the loader is created, so
     every sample decodes and degrades);
   - ``[scaling]``: ``tools/bench_scaling.py`` at ``--sizes 1,2``,
     272x480, 2 frames a rank (ranks sharing cuda:0 over gloo): every
     rank launches every kernel; the N = 2 streamed frames against the
     unsharded model on the same frames, bf16 tolerance;
   - ``[roofline]``: ``tools/bench_roofline.py``: one line an op, no
     ``peak_share`` above 1.05; the measured ceilings and each ``k1_``
     row's share of ``F.conv2d``'s rate; each of its K1 specs that the
     serving forward lacks held against the plain version in f32 and bf16
     and timed as in phase 3;
   - ``[kernel-vs-library]``: the kernel-against-library tools at their
     defaults, each under the call-site recording (the tools' own call
     sites too): ``tools/bench_conv.py --check`` (K1 against
     ``conv3x3_library``, the same function by ``F.conv2d`` and eager
     ops, at the JAX tool's four bf16 shapes: kernel, library and floor
     ms, ``roofline_report``'s lines), ``tools/bench_warp.py --check``
     (K4 against ``F.grid_sample`` on an f32 grid) and
     ``tools/bench_model_ab.py`` (the four conv/warp variants of the bf16
     serving forward, interleaved: ms/frame, device ms/frame, launches);
     every record finite, each max|diff| against the plain version within
     the atol above; each variant launches a forward exactly what the
     serving forward launches of the kernels it keeps (conv3x3 59,
     correlation 4, warp 4) and none of those it swaps; each bf16
     variant's output >= 40 dB PSNR (Y, border 4) against kernel/kernel's;
     the four variants in f32 (TF32 off) within rtol 2e-3, atol 5e-4 of
     kernel/kernel; each argument spec the tools gave that no earlier
     phase had held and timed as in phase 3;
   then one forward under torch.profiler for device time by kernel group
   and idle share;
5. f32 parity: the f32 serving forward through the kernels against the
   same forward through the plain versions on the card (rtol 2e-3,
   atol 5e-4), and a small window on the card against the CPU path;
6. training at ``VSRConfig()`` full width (bf16 compute, f32 master
   parameters, LR crop 64, batch 4, window 3, depth branch at 1/2 res) on
   in-memory synthetic clips:
   - grad check: f32, TF32 off, one batch, the loss and every parameter's
     gradient through the kernels' autograd Functions against autograd
     through the plain versions (each gradient over its largest magnitude,
     rtol 2e-3, atol 5e-4);
   - fixed batch: 10 bf16 steps (warmup 0, lr 1e-4), counts set to 0 before
     each step and read after: every step launches all three kernels; the
     loss is finite and falls; each conv's kernel layout is rebuilt once a
     step and never stale; the kernels' argument specs on this path are
     recorded;
   - train kernels: at each of those specs, f32 and bf16, the forward
     against the plain version and the Function's gradients against
     autograd of the plain version (TOL, gradients over their largest
     magnitude);
   - throughput: ``training.loop.train`` for 10 warm-up + 30 timed steps:
     steps/s and frames/s from the loop's log, peak memory; host wall a
     step on a device batch; one profiled step: busy, idle share, device
     time by group;
   - checkpoint: save, restore into a fresh state, bit-equal;
   - eval: ``evaluate_all`` PSNR/SSIM on a synthetic clip, bf16 and f32.

Between phases 5 and 6, the reference-era model options at full width:

- reference-era forward: ``serving_config(warp_features=True,
  sr_head_style="two_stage")``, bf16, the same window -> (1, 2160, 3840,
  3): all three kernels launch, K1 with ``shuffle=True`` at 64 -> 256 on
  540x960 and 1080x1920 and K4 at C = 65; each argument spec the serving
  forward did not have is held and timed as in phase 3 (the shuffled
  conv also without its shuffle's copy); ``sr_head.Conv_1`` at 4K (the
  tap-sum against F.conv2d); phase 4's throughput and profile (with the
  stages' ``record_function`` spans) beside the espcn forward's; phase
  5's f32 parity;
- ``serving_config(sr_espcn_mid=256)``: one forward, its new specs held
  and timed, throughput and profile.

After phase 6:

- quality: the serving-path quality tool
  (``video_super_resolution_tpu_torch/tools/quality_serving.py``) on its
  ``hard`` variant at full width (depth branch at 1/4 res: at crop 64 the
  hourglass runs from 16x64 down to 1x4 maps): ``train`` for 300 steps, then
  the six held-out ``heval_*`` clips at full size (LR 288x512, 7 frames,
  batch 4 windows) through ``serving`` (bf16) and ``f32_kernels`` (TF32
  off); per-clip PSNR and the delta bf16 - f32, each within 0.05 dB; counts
  set to 0 before the train and before each eval path, read after; every
  argument spec of the hard train step and the eval forward that no
  earlier phase had, held against the plain version and timed as in phase
  3 (the train step's also through the backward);
- ab: the A/B tool (``tools/quality_ab.py``): each of its seven variants
  through ``run_variant`` on the card (f32, TF32 off) for 20 steps on the
  tool's clips, counts set to 0 before and read after (each launches
  every kernel); the trained weights evaluated on the held-out clips on
  the CPU through the plain versions: |PSNR card - PSNR CPU| within 1e-5
  dB; every argument spec of the runs that no earlier phase had (K3 at
  d = 3 down to 3x3 maps, K4 at C = 25, K1 at 3-96 channels in f32)
  held against its plain version in f32 and bf16, forward and backward,
  and timed as in phase 3;
- probe (run before ``[dispatch]``): one line saying whether g++, png.h,
  libpng16 and PIL exist; the native loader needs g++ alone (its PNG
  decoder is the port's own, ``csrc/png_decode.h``), and the run fails
  without it; the clip and CLI phase runs when PIL does (it reads and
  writes PNGs);
- ``[png]`` (right after the probe): PNGs that PIL writes (RGB, RGBA, L,
  P with transparency, 96x160) through the port's decoder, each
  bit-equal to PIL's bytes x float32(1/255) (the C code's ``byte *
  (1/255.f)``; PIL is the only oracle on the card, which has no libpng);
  then ``tools/bench_png.py`` on two 1080x1920 frames: the port and PIL
  decoding them, bit-equal, ms a frame on the host;
- clip and CLI: a 5-frame 540x960 PNG clip through ``api.upscale_clip``,
  which must equal ``eval_step`` on each window (frames/s); ``cli train``
  at ``VSRConfig()`` for 20 steps on HR-only 256x256 PNG clips (its log's
  ``native_loader`` must be 1: compact batches, uint8 HR and bf16 LR;
  steps/s beside phase 6's in-memory loop), ``cli eval`` and ``cli infer``
  (5 PNGs of 3840x2160) on its checkpoint, ``cli import-weights`` on a
  saved state_dict;
- async checkpoint: the time ``save`` blocks against ``wait()``; the
  parameters are changed right after ``save`` and the restore is still
  bit-equal to the state at ``save``;
- parallel: the parallel modes at full width (the ``parallel_modes``
  case, which ``parallel/launch.py`` runs in each rank: temporal and
  spatial streaming of a 4-frame 540x960 clip, the TP forward, the dp and
  the sp train step at ``VSRConfig()``), f32 with TF32 off, every rank
  against the unsharded model on the card (forwards rtol/atol 1e-4, loss
  and grad_norm rtol 1e-5), and bf16 times beside the unsharded forms;
  first at world size 1 on NCCL in this process, then as 2 gloo
  processes that share cuda:0 (NCCL takes one GPU a rank); every kernel
  must launch in every mode on every rank (counts set to 0 before each
  mode, read after); the route of each collective, and a probe of which
  collectives gloo carries for CUDA tensors, which must match the routes
  ``runtime/mesh.py`` takes; bf16
  ``stream_upscale`` against ``upscale_clip`` on an 8-frame clip; the
  strips' rows; the TP trunk's conv shapes at n = 2 and 4, held against
  the plain version and timed.

The last two lines are the ``{"kernels": [...]}`` summary (per-forward
totals over the serving forward's specs; ``launches`` counts the serving
forward, ``train_step_launches`` one train step, ``ref_era_launches`` and
``espcn_mid_launches`` the two option forwards, ``quality_train_launches``
the quality phase's 300 steps, ``quality_eval_launches`` each of its eval
paths, ``ab_launches`` each A/B variant's 20 steps and eval, ``new_specs``
the new argument specs of the option forwards, the quality phase, the
A/B runs, the roofline and the kernel tools with their times,
``dispatch_launches`` each dispatch control, ``scaling_launches`` each
rank of each N,
``roofline_launches`` (conv3x3) the roofline's ``k1_`` rows,
``bench_launches`` the headline bench's launches a serving frame and a
train step, ``bench_conv_launches`` and ``bench_warp_launches`` the two
kernel tools'
runs, ``model_ab_launches`` each A/B variant's timed forwards,
``parallel_stream_launches`` the world-size-1 8-frame ``stream_upscale``,
``parallel_mode_launches`` each mode at world size 1 and on each of the 2
gloo ranks, ``tp_specs`` the TP conv shapes) and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # f32 outside the tensor cores
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
MODEL_TOL = (2e-3, 5e-4)                        # composed-model rtol, atol
WINDOW = (1, 3, 540, 960, 3)
TIMED_FORWARDS = 40
GRAPH_CALLS = 10


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=None):
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    if reps is None:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        reps = max(3, min(50, int(0.05 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, replays=5):
    """Device time of fn() in ms: GRAPH_CALLS calls captured in one CUDA
    graph, replayed `replays` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * GRAPH_CALLS)
    del graph
    return ms


class Kernels:
    """The port's kernels, their plain versions and the model call sites
    that reach them."""

    def __init__(self):
        from video_super_resolution_tpu_torch.models import common, flow_net, vsr
        from video_super_resolution_tpu_torch.ops import correlation, fused_conv, warp

        self.wrappers = {"conv3x3": fused_conv.fused_conv3x3,
                         "correlation": correlation.correlation,
                         "warp": warp.backward_warp}
        self.plain = {"conv3x3": conv_plain,
                      "correlation": correlation.correlation_plain,
                      "warp": warp.warp_plain}
        self.sources = {
            "conv3x3": ("video_super_resolution_tpu_torch/csrc/conv3x3.cu",
                        "video_super_resolution_tpu/ops/pallas/fused_conv.py:383"),
            "correlation": ("video_super_resolution_tpu_torch/csrc/correlation.cu",
                            "video_super_resolution_tpu/ops/pallas/correlation_tpu.py:63"),
            "warp": ("video_super_resolution_tpu_torch/csrc/warp.cu",
                     "video_super_resolution_tpu/ops/pallas/warp_shift_tpu.py:197"),
        }
        self.sites = [(common, "fused_conv3x3", "conv3x3"),
                      (flow_net, "correlation", "correlation"),
                      (flow_net, "backward_warp", "warp"),
                      (vsr, "backward_warp", "warp")]

    def reset(self):
        for fn in self.wrappers.values():
            fn.launches = 0

    def counts(self):
        return {k: fn.launches for k, fn in self.wrappers.items()}

    @contextlib.contextmanager
    def patched(self, make, extra=()):
        """Replace each call site's function (and those of ``extra``, more
        (module, attribute, kernel) sites) by make(name, original)."""
        sites = self.sites + list(extra)
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]
        try:
            for mod, attr, name in sites:
                setattr(mod, attr, make(name, self.wrappers[name]))
            yield
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def recording(self, calls, extra=()):
        """Call sites (and ``extra`` ones) go through the kernels;
        calls[name] counts each call's argument spec."""
        def make(name, fn):
            sig = inspect.signature(fn)

            def rec(*args, **kw):
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                calls[name][spec_of(name, bound.arguments)] += 1
                return fn(*args, **kw)
            return rec
        return self.patched(make, extra)

    def plain_path(self):
        """Call sites run the plain PyTorch versions on the card."""
        from video_super_resolution_tpu_torch.ops.fused_conv import (
            PreparedConv3x3,
            unpack_conv3x3_weight,
        )

        def make(name, fn):
            plain = self.plain[name]
            if name != "conv3x3":
                return plain

            def conv(x, w, b=None, slope=0.1, dilation=1, res=None,
                     res_repeat=1, shuffle=False, params=None):
                if isinstance(w, PreparedConv3x3):
                    if params is None:
                        w, b = unpack_conv3x3_weight(w), w.bias
                    else:   # the parameters themselves: gradients reach them
                        w, b = params
                        b = (torch.zeros(w.shape[0], device=x.device)
                             if b is None else b.to(x.dtype))
                return plain(x, w, b, slope, dilation, res, res_repeat, shuffle)
            return conv
        return self.patched(make)


def conv_plain(x, w, b, slope=0.1, dilation=1, res=None, res_repeat=1,
               shuffle=False):
    """The conv kernel's plain version, then pixel_shuffle(2) if shuffle (as
    ``fused_conv3x3`` applies it after the kernel)."""
    from video_super_resolution_tpu_torch.ops.fused_conv import conv3x3_plain
    from video_super_resolution_tpu_torch.ops.pixel_shuffle import pixel_shuffle

    out = conv3x3_plain(x, w, b, slope, dilation, res, res_repeat)
    return pixel_shuffle(out, 2) if shuffle else out


def spec_of(name, a):
    if name == "conv3x3":
        res = a["res"]
        w = a["w"]
        return (tuple(a["x"].shape), a["x"].dtype,
                w.shape[0] if isinstance(w, torch.Tensor) else w.cout,
                a["dilation"], float(a["slope"]),
                None if res is None else (tuple(res.shape), res.dtype),
                a["res_repeat"], bool(a["shuffle"]))
    if name == "correlation":
        return (tuple(a["f1"].shape), a["f1"].dtype, a["max_displacement"],
                a["slope"], a["out_dtype"])
    return (tuple(a["img"].shape), a["img"].dtype, a["padding_mode"])


def make_case(name, spec, dtype, gen):
    """Random inputs of a recorded spec, cast to dtype; returns the wrapper
    arguments, the plain version's arguments, a library callable or None,
    FLOP and bytes. The conv's weight reaches the wrapper prepared, as the
    model's modules hand it over, and the plain version as OIHW. The
    library callables compute the kernel's whole function: the conv with
    its epilogue (``tools/bench_conv.py:conv3x3_library``), the warp on an
    f32 grid (``tools/bench_warp.py:warp_library``)."""
    from video_super_resolution_tpu_torch.ops.fused_conv import prepare_conv3x3_weight
    from video_super_resolution_tpu_torch.tools.bench_conv import conv3x3_library
    from video_super_resolution_tpu_torch.tools.bench_warp import warp_library
    from video_super_resolution_tpu_torch.utils.profiling import (
        conv3x3_roofline_ms,
        correlation_roofline_ms,
        warp_roofline_ms,
    )

    dev = "cuda"

    def rn(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    if name == "conv3x3":
        xs, _, cout, d, slope, res, rr, shuffle = spec
        b, h, w, cin = xs
        x = rn(xs, dtype)
        wt = rn((cout, cin, 3, 3), torch.float32) / math.sqrt(9 * cin)
        bias = rn((cout,), dtype) * 0.1
        r = None
        if res is not None:
            rdt = torch.float32 if res[1] == torch.float32 else dtype
            r = rn(res[0], rdt)
        prep = prepare_conv3x3_weight(wt, bias, dtype)
        args = (x, prep, None, slope, d, r, rr, shuffle)
        plain_args = (x, wt, prep.bias, slope, d, r, rr, shuffle)
        wl = wt.to(dtype)
        lib = lambda: conv3x3_library(x, wl, prep.bias, *args[3:])  # noqa: E731
        c = conv3x3_roofline_ms(b, h, w, cin, cout, x.element_size(),
                                0 if r is None else r.numel() * r.element_size())
        return args, plain_args, lib, c["flops"], c["bytes"]
    if name == "correlation":
        xs, in_dt, d, slope, out_dt = spec
        od = dtype if out_dt == in_dt else out_dt   # the forward's: out = in
        b, h, w, c = xs
        f1, f2 = rn(xs, dtype), rn(xs, dtype)
        r = correlation_roofline_ms(b, h, w, c, d, dtype.itemsize, od.itemsize)
        args = (f1, f2, d, slope, od)
        return args, args, None, r["flops"], r["bytes"]
    xs, _, mode = spec
    b, h, w, c = xs
    img = rn(xs, dtype)
    flow = rn((b, h, w, 2), torch.float32) * 3.0
    lib = lambda: warp_library(img, flow, mode)  # noqa: E731
    r = warp_roofline_ms(b, h, w, c, dtype.itemsize)
    return (img, flow, mode), (img, flow, mode), lib, r["flops"], r["bytes"]


def plan_note(name, spec, args):
    """The conv kernel's tile plan for a recorded spec; for the padded
    route also the same conv's time on an input padded beforehand (its
    weight padded with zero channels), so that the difference is what the
    staging copy costs inside the kernel's time."""
    if name != "conv3x3":
        return ""
    import torch.nn.functional as F

    from video_super_resolution_tpu_torch.ops import fused_conv as fc

    p = fc.conv3x3_plan(spec[0], spec[2], spec[1],
                        torch.cuda.get_device_properties(0).multi_processor_count)
    note = (f"; plan: route {p.route} (Cx {p.cx}), kc {p.kc}, tile "
            f"{p.th}x{p.tw} px x {p.bn} ch, {p.tiles} tiles, split-K "
            f"{p.splits}")
    if spec[7]:     # the wrapper's time includes the pixel_shuffle's copy
        ms = graph_ms(lambda: fc.fused_conv3x3(*args[:7]))
        note += f"; {ms:.4f} ms without the shuffle (the kernel alone)"
    if p.route == "tma+pad":
        x, prep = args[0], args[1]
        pad = (0, p.cx - x.shape[3])
        w8 = F.pad(fc.unpack_conv3x3_weight(prep), (0, 0, 0, 0) + pad)
        prep8 = fc.prepare_conv3x3_weight(w8, prep.bias, x.dtype)
        x8 = F.pad(x, pad)
        ms = graph_ms(lambda: fc.fused_conv3x3(x8, prep8, None, *args[3:]))
        note += f", {ms:.4f} ms on x padded beforehand"
    return note


def host_note(kernels, specs, gen, reps=200):
    """Host time a call (no synchronisation inside the loop) of the conv
    wrapper and of the library route (F.conv2d and its eager epilogue) at
    the smallest recorded shape, where the device work is least: what the
    forward's host path pays per conv."""
    spec = min(specs, key=lambda sp: math.prod(sp[0]))
    args, _, lib, _, _ = make_case("conv3x3", spec, spec[1], gen)

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / reps * 1e6

    k_us = host_us(lambda: kernels.wrappers["conv3x3"](*args))
    log(f"[host] conv3x3 at {spec[0]} -> {spec[2]}: wrapper {k_us:.1f} us a "
        f"call, library route {host_us(lib):.1f} us (host clock, {reps} "
        f"calls)")


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_build():
    from video_super_resolution_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] {len([p for p in _build.sources() if p.suffix == '.cu'])} "
        f"sources -> {_build.build_info['path']} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_info['seconds']:.2f} s, "
        f"cached={_build.build_info['cached']})")
    spills = []
    for src, text in sorted(_build.build_info.get("ptxas", {}).items()):
        fn = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = kernel_name(line)
            elif "spill" in line:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if m and (int(m.group(1)) or int(m.group(2))):
                    spills.append(f"{src}:{fn}")
                    log(f"[build] SPILL {src} {fn}: {line.strip()}")
            elif "registers" in line:
                log(f"[build] {src} {fn}: {line.strip()}")
    bf16_spills = [s for s in spills if "conv3x3" in s and "bfloat16" in s]
    log(f"[build] kernels that spill: {spills or 'none'}; bf16 conv kernels "
        f"spill-free: {not bf16_spills}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    return card


def kernel_name(line):
    """Readable name of the function on a ptxas 'Compiling entry function'
    line: the kernel's name and its template arguments."""
    for k in ("conv3x3_kernel", "conv3x3_splitk_reduce", "correlation_kernel",
              "warp_kernel", "warp_pair_kernel"):
        i = line.find(k + "I")
        if i < 0:
            continue
        rest, args = line[i + len(k) + 1:], []
        while rest and rest[0] != "E":
            m = re.match(r"13__nv_bfloat16|f|Li(\d+)E|Lb([01])E", rest)
            if not m:
                break
            args.append(m.group(1) or m.group(2)
                        or ("bfloat16" if m.group(0)[0] == "1" else "float"))
            rest = rest[m.end():]
        return f"{k}<{','.join(args)}>"
    return line.split("'")[1] if "'" in line else line.strip()


def phase_forward(kernels, cfg, label="serving"):
    from video_super_resolution_tpu_torch import api

    model = api.build_model(cfg, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(1)
    window = torch.rand(WINDOW, generator=gen).cuda()
    calls = collections.defaultdict(collections.Counter)
    with kernels.recording(calls):
        kernels.reset()
        hr = api.eval_step(model, window)
        torch.cuda.synchronize()
        counts = kernels.counts()
    want = (1, 4 * WINDOW[2], 4 * WINDOW[3], 3)
    log(f"[forward] bf16 {label} forward {tuple(window.shape)} -> "
        f"{tuple(hr.shape)}; launches {counts}")
    if tuple(hr.shape) != want:
        raise AssertionError(f"output shape {tuple(hr.shape)} != {want}")
    if not bool(torch.isfinite(hr).all()):
        raise AssertionError("non-finite output")
    if float(hr.min()) < 0.0 or float(hr.max()) > 1.0:
        raise AssertionError("eval_step output outside [0, 1]")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
        if n != sum(calls[name].values()):
            raise AssertionError(f"{name}: {n} launches vs "
                                 f"{sum(calls[name].values())} calls")
    return model, window, calls, counts


def check_spec(kernels, name, spec, n, gen):
    """The kernel at one recorded argument spec (n calls a forward): held
    against its plain version in f32 and bf16 (TOL), timed at the spec's
    own dtype beside the plain version, the library call and the bound.
    Returns that dtype's numbers."""
    main_dt = spec[1]
    for dt in (torch.float32, torch.bfloat16):
        args, pargs, lib, flops, nbytes = make_case(name, spec, dt, gen)
        out = kernels.wrappers[name](*args)
        ref = kernels.plain[name](*pargs)
        torch.cuda.synchronize()
        rtol, atol = TOL[dt]
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol)
        line = (f"[kernel] {name} {spec[0]} {str(dt)[6:]} "
                f"extra={spec[2:]} x{n}: max|diff| {err:.3e}")
        del out, ref
        if not ok:
            raise AssertionError(line + f" exceeds rtol {rtol} atol {atol}")
        if dt != main_dt:
            log(line)
            continue
        t_h = cuda_ms(lambda: kernels.wrappers[name](*args))
        t_k = graph_ms(lambda: kernels.wrappers[name](*args))
        t_p = graph_ms(lambda: kernels.plain[name](*pargs))
        t_l = graph_ms(lib) if lib is not None else None
        b_ms, b_by = bound_ms(flops, nbytes, dt)
        rate = flops / t_k / 1e9
        log(line + f"; kernel {t_k:.4f} ms device ({t_h:.4f} "
            f"host-incl.), plain {t_p:.4f} ms, library "
            f"{'null' if t_l is None else f'{t_l:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by}) = {b_ms / t_k:.3f} of the "
            f"kernel's time, {rate:.1f} TFLOP/s = "
            f"{rate * 1e12 / PEAK_FLOPS[dt]:.4f} of the "
            f"{str(dt)[6:]} peak" + plan_note(name, spec, args))
        result = dict(err=err, ms=t_k, plain_ms=t_p, library_ms=t_l,
                      bound_ms=b_ms, bound_by=b_by,
                      ops_ms=flops / PEAK_FLOPS[dt] * 1e3,
                      bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    del args, pargs, lib
    torch.cuda.empty_cache()
    return result


def phase_kernels(kernels, calls, counts):
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for name in ("conv3x3", "correlation", "warp"):
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, lib_ms=0.0,
                   ops_ms=0.0, bytes_ms=0.0)
        has_lib = True
        max_err = 0.0
        for spec, n in sorted(calls[name].items(), key=lambda kv: str(kv[0])):
            r = check_spec(kernels, name, spec, n, gen)
            max_err = max(max_err, r["err"])
            for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms"):
                tot[k] += n * r[k]
            if r["library_ms"] is None:
                has_lib = False
            else:
                tot["lib_ms"] += n * r["library_ms"]
        if name == "conv3x3":
            host_note(kernels, calls[name], gen)
        src, replaces = kernels.sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": max_err,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("operations" if tot["ops_ms"] > tot["bytes_ms"]
                         else "bytes"),
            "library_ms": tot["lib_ms"] if has_lib else None,
        })
        log(f"[kernel] {name} per forward: {json.dumps(rows[-1])}")
    return rows


def phase_throughput(model, window, label="serving"):
    """Per-forward device time of back-to-back bf16 forwards (one CUDA event
    between consecutive forwards): median and p75, the highest percentile
    with at least ten samples above it."""
    from video_super_resolution_tpu_torch import api

    for _ in range(2):
        api.eval_step(model, window)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TIMED_FORWARDS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for ev in events[1:]:
        api.eval_step(model, window)
        ev.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    times = sorted(a.elapsed_time(b) for a, b in zip(events, events[1:]))
    median = statistics.median(times)
    p75 = times[TIMED_FORWARDS - 11]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[throughput] bf16 {label} forward 540x960 -> 2160x3840, "
        f"{TIMED_FORWARDS} forwards: median {median:.3f} ms/frame "
        f"({1000.0 / median:.3f} frames/s), p75 {p75:.3f} ms, min "
        f"{times[0]:.3f} ms, max {times[-1]:.3f} ms (CUDA events); host wall "
        f"{wall / TIMED_FORWARDS * 1e3:.3f} ms/frame; peak memory "
        f"{peak:.3f} GiB")
    return {"median": median, "p75": p75, "peak_gib": peak}


def phase_profile(model, window, label="serving"):
    """One bf16 forward under torch.profiler: device time by kernel group
    and the idle share between the first kernel's start and the last
    kernel's end (one stream, so kernels do not overlap); the model's
    stage ranges (``record_function``) as the device spans them."""
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.tools.profile_prefix import (
        RANGES,
        device_events,
        device_spans,
        profiled,
    )

    prof = profiled(lambda: api.eval_step(model, window), 1,
                    torch.device("cuda"))
    kernels = device_events(prof)
    if not kernels:
        log("[profile] the profiler recorded no device events: device time "
            "by kernel and idle share not measured")
        return
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    busy = sum(e.time_range.end - e.time_range.start for e in kernels)
    groups = collections.Counter()
    for e in kernels:
        groups[kernel_group(e.name)] += e.time_range.end - e.time_range.start
    log(f"[profile] {label}, one forward: {len(kernels)} device events, span "
        f"{(end - start) / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / (end - start):.4f}")
    for g, us in groups.most_common():
        log(f"[profile] {g}: {us / 1e3:.3f} ms ({us / busy:.4f} of busy)")
    stages = device_spans(prof)
    log("[profile] stage spans on the device (record_function ranges): "
        + ("; ".join(f"{n} {stages[n] / 1e3:.3f} ms" for n in RANGES
                     if n in stages) or "not recorded"))


def kernel_group(name):
    lowered = name.lower()
    for keys, group in ((("conv3x3_",), "conv3x3 (port)"),
                        (("correlation_kernel",), "correlation (port)"),
                        (("warp_kernel", "warp_pair_kernel"), "warp (port)"),
                        (("dgrad", "wgrad"),
                         "cuDNN conv backward (dgrad, wgrad)"),
                        (("fprop", "cudnn", "conv", "implicit"),
                         "cuDNN (stride-2 convs)"),
                        (("gemm",), "matmul (tap-sum convs)"),
                        (("catarray",), "concat"),
                        (("im2col", "col2im"),
                         "unfold/fold (correlation backward)"),
                        (("multi_tensor_apply",), "foreach (clip, Adam)"),
                        (("index", "gather", "scatter"),
                         "gather/index (resize, pad; warp backward)"),
                        (("softmax", "reduce"), "reductions (softmax, sums)"),
                        (("elementwise", "copy"), "elementwise and copies")):
        if any(k in lowered for k in keys):
            return group
    return "other"


def phase_f32(kernels, window, cfg, label="serving"):
    from video_super_resolution_tpu_torch import api

    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                compute_dtype="float32"))
    model = api.build_model(cfg, device="cuda", seed=0)
    rtol, atol = MODEL_TOL
    kernels.reset()
    out_k = api.upscale_window(model, window)
    n_k = sum(kernels.counts().values())
    with kernels.plain_path():
        kernels.reset()
        out_p = api.upscale_window(model, window)
        torch.cuda.synchronize()
        if sum(kernels.counts().values()) != 0:
            raise AssertionError("plain path launched a kernel")
    err = (out_k - out_p).abs().max().item()
    log(f"[f32] {label} forward, kernels ({n_k} launches) vs plain on the "
        f"card: max|diff| {err:.3e}, |out| max {out_p.abs().max().item():.3f}")
    if not torch.allclose(out_k, out_p, rtol=rtol, atol=atol):
        raise AssertionError(f"f32 forward exceeds rtol {rtol} atol {atol}")
    small = torch.rand((1, 3, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    cpu_model = api.build_model(cfg, device="cpu", seed=0)
    out_cpu = api.upscale_window(cpu_model, small)
    out_gpu = api.upscale_window(model, small).cpu()
    err = (out_gpu - out_cpu).abs().max().item()
    log(f"[f32] small window (1, 3, 64, 64, 3), card vs CPU path: "
        f"max|diff| {err:.3e}")
    if not torch.allclose(out_gpu, out_cpu, rtol=rtol, atol=atol):
        raise AssertionError("card vs CPU path exceeds the model tolerance")


# ---------------------------------------------------------------- training

TRAIN_BATCH, TRAIN_CROP = 4, 64     # VSRConfig()'s data.batch_size, crop_size
FIXED_STEPS = 10
WARM_TRAIN_STEPS, TIMED_TRAIN_STEPS = 10, 30
LOG_EVERY = 10


def train_cfg(**train_kw):
    """VSRConfig() (full width, bf16 compute, depth branch at 1/2 res) with
    ``train_kw`` replaced."""
    from video_super_resolution_tpu_torch import VSRConfig

    cfg = VSRConfig()
    return cfg.replace(train=dataclasses.replace(cfg.train, **train_kw))


def train_data():
    """In-memory synthetic HR clips (a smooth translation, the full-spectrum
    translation, layered occlusions, a shear), degraded x4 by the port's
    bicubic: the train set; and one smooth clip for evaluation."""
    from video_super_resolution_tpu_torch.data import synthetic as syn
    from video_super_resolution_tpu_torch.data.dataset import ClipDataset

    h, w = 256, 320
    clips = {"smooth": syn.moving_gradient_clip(7, h, w, 2.0, -1.0, seed=0)[0],
             "detail": syn.detail_clip(7, h, w, seed=1),
             "layered": syn.layered_clip(7, h, w, seed=2),
             "shear": syn.shear_clip(7, h, w, seed=3)}
    train = ClipDataset(clips_hr=clips, crop_size=TRAIN_CROP, seed=0)
    _, hr = syn.synthetic_clip_pair(5, 256, 256, 4, seed=4)
    return train, ClipDataset(clips_hr={"eval": hr}, crop_size=TRAIN_CROP)


def device_batch(batch):
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def loss_and_grads(model, batch):
    from video_super_resolution_tpu_torch.ops.losses import charbonnier_loss

    model.zero_grad(set_to_none=True)
    loss = charbonnier_loss(model(batch["lr"]), batch["hr"])
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.named_parameters()}


def grad_scales(want):
    """Per tensor, the scale its gradient is compared at: its largest
    magnitude (a gradient is a sum over many pixels; its small entries carry
    the rounding of the large), at least 1e-4 of the largest over all
    tensors (the score bias before the softmax over neighbours has a
    gradient of 0 plus rounding)."""
    top = max(float(g.abs().max()) for g in want.values())
    return {n: max(float(g.abs().max()), 1e-4 * top) for n, g in want.items()}


def phase_train_grads(kernels, batch):
    """f32, TF32 off: the loss and every parameter's gradient through the
    kernels' autograd Functions against the same through the plain
    versions (autograd of plain PyTorch), one batch."""
    from video_super_resolution_tpu_torch import api

    model = api.build_model(train_cfg(compute_dtype="float32"), "cuda", seed=0)
    kernels.reset()
    loss_k, g_k = loss_and_grads(model, batch)
    counts = kernels.counts()
    with kernels.plain_path():
        kernels.reset()
        loss_p, g_p = loss_and_grads(model, batch)
        if sum(kernels.counts().values()):
            raise AssertionError("plain path launched a kernel")
    rtol, atol = MODEL_TOL
    scale = grad_scales(g_p)
    errs = {n: float((g_k[n] - g_p[n]).abs().max()) / scale[n] for n in g_p}
    bad = [n for n in g_p if not torch.allclose(
        g_k[n] / scale[n], g_p[n] / scale[n], rtol=rtol, atol=atol)]
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    log(f"[train-grad] f32 loss and gradients of {len(g_p)} parameters, "
        f"kernels ({counts}) vs plain on the card: loss {loss_k:.6f} vs "
        f"{loss_p:.6f}; max|diff| / scale, worst: "
        + ", ".join(f"{n} {e:.3e}" for n, e in worst))
    if bad or abs(loss_k - loss_p) > atol + rtol * abs(loss_p):
        raise AssertionError(f"f32 gradients beyond rtol {rtol} atol {atol} "
                             f"(over each tensor's scale): {bad}")
    for n, c in counts.items():
        if c <= 0:
            raise AssertionError(f"grad check: {n} was not launched")


def phase_train_fixed(kernels, batch):
    """bf16, warmup 0, lr 1e-4: FIXED_STEPS steps on one batch. Each step
    launches all three kernels; the loss is finite and falls; each conv's
    kernel layout is rebuilt once a step (the optimizer's in-place update)
    and never served stale. The first step records the argument specs the
    kernels get on the train path."""
    from video_super_resolution_tpu_torch.models import common
    from video_super_resolution_tpu_torch.ops.fused_conv import unpack_conv3x3_weight
    from video_super_resolution_tpu_torch.training.state import create_train_state
    from video_super_resolution_tpu_torch.training.step import make_train_step

    cfg = train_cfg(warmup_steps=0, lr=1e-4)
    state = create_train_state(cfg, "cuda", seed=0)
    step = make_train_step(cfg.train.charbonnier_eps)
    calls = collections.defaultdict(collections.Counter)
    built = []
    real = common.prepare_conv3x3_weight
    common.prepare_conv3x3_weight = lambda *a: built.append(1) or real(*a)
    losses, per_step, rebuilds = [], [], []
    try:
        for i in range(FIXED_STEPS):
            kernels.reset()
            del built[:]
            if i == 0:
                with kernels.recording(calls):
                    state, m = step(state, batch)
            else:
                state, m = step(state, batch)
            losses.append(float(m["loss"]))
            per_step.append(kernels.counts())
            rebuilds.append(len(built))
    finally:
        common.prepare_conv3x3_weight = real
    convs = [mod for mod in state.model.modules()
             if isinstance(mod, common._Conv3x3)]
    entries = sum(len(mod._prepared) for mod in convs)
    stale = 0
    for mod in convs:
        for dt, lo, hi, with_bias in list(mod._prepared):
            prep = mod.prepared(dt, slice(lo, hi), with_bias)
            stale += not torch.equal(unpack_conv3x3_weight(prep),
                                     mod.weight[:, lo:hi].detach().to(dt))
    log(f"[train-fixed] bf16 VSRConfig() batch {TRAIN_BATCH} crop "
        f"{TRAIN_CROP}, {FIXED_STEPS} steps at lr 1e-4: loss "
        + " ".join(f"{v:.5f}" for v in losses)
        + f"; launches a step {per_step[-1]}; kernel layouts rebuilt a step "
        f"{rebuilds} of {entries} cached, stale after the update: {stale}")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"fixed-batch loss did not fall: {losses}")
    for c in per_step:
        if min(c.values()) <= 0:
            raise AssertionError(f"a train step did not launch every kernel: {c}")
    if stale or any(r != entries for r in rebuilds):
        raise AssertionError("prepared conv weights stale or rebuilt more "
                             "than once a step")
    return calls, per_step[-1]


def train_case(name, spec, dtype, gen):
    """Random inputs of a recorded spec that require grad; the wrapper's
    arguments; the plain version's arguments without the LeakyReLU; its
    slope (None: no activation); the output's shape and dtype. The conv's
    weight is an f32 OIHW parameter."""
    def rn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt).requires_grad_()

    if name == "conv3x3":
        xs, _, cout, d, slope, res, rr, _ = spec
        b, h, w, cin = xs
        ins = [rn(xs, dtype), rn((cout, cin, 3, 3), torch.float32,
                                 1 / math.sqrt(9 * cin)),
               rn((cout,), torch.float32, 0.1)]
        if res is not None:
            ins.append(rn(res[0], torch.float32 if res[1] == torch.float32
                          else dtype))
        r = ins[3] if res is not None else None
        return (ins, (*ins[:3], slope, d, r, rr), (*ins[:3], 1.0, d, r, rr),
                None if slope == 1.0 else slope, (b, h, w, cout), dtype)
    if name == "correlation":
        xs, in_dt, d, slope, out_dt = spec
        od = dtype if out_dt == in_dt else out_dt
        ins = [rn(xs, dtype), rn(xs, dtype)]
        return (ins, (*ins, d, slope, od), (*ins, d, None, od), slope,
                (*xs[:3], (2 * d + 1) ** 2), od)
    xs, _, mode = spec
    ins = [rn(xs, dtype), rn((*xs[:3], 2), torch.float32, 3.0)]
    return ins, (*ins, mode), (*ins, mode), None, xs, dtype


def phase_train_kernels(kernels, calls, counted="a step"):
    """At every argument spec the train step gave each kernel, in f32 and
    bf16: the forward against the plain version (TOL) and the gradients of
    the autograd Function (explicit backward) against autograd of the plain
    version, each over the reference's largest magnitude (TOL). The
    LeakyReLU's derivative jumps at 0, and the kernel's and the plain
    version's pre-activations differ by rounding, so the reference takes
    it from the kernel's output, as the backward does, and autograd of the
    plain version without the activation gives the rest."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name in ("conv3x3", "correlation", "warp"):
        if not calls[name]:
            continue
        worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
        for spec in sorted(calls[name], key=str):
            for dt in (torch.float32, torch.bfloat16):
                ins, args, lin_args, slope, out_shape, out_dt = train_case(
                    name, spec, dt, gen)
                g = torch.randn(out_shape, generator=gen, device="cuda").to(out_dt)
                out = kernels.wrappers[name](*args)
                got = torch.autograd.grad(out, ins, g)
                ref = kernels.plain[name](*args).detach()
                g_lin = g if slope is None else torch.where(out >= 0, g, g * slope)
                want = torch.autograd.grad(kernels.plain[name](*lin_args),
                                           ins, g_lin)
                torch.cuda.synchronize()
                rtol, atol = TOL[dt]
                f_err = (out.float() - ref.float()).abs().max().item()
                if not torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol):
                    raise AssertionError(f"[train-kernel] {name} {spec} {dt} "
                                         f"forward max|diff| {f_err:.3e}")
                for a, b in zip(got, want):
                    s = b.float().abs().max().clamp(min=1e-30)
                    if not torch.allclose(a.float() / s, b.float() / s,
                                          rtol=rtol, atol=atol):
                        raise AssertionError(
                            f"[train-kernel] {name} {spec} {dt} backward: "
                            f"max|diff| / max|grad| "
                            f"{((a.float() - b.float()).abs().max() / s).item():.3e}")
                    worst[dt][1] = max(worst[dt][1], ((a.float() - b.float())
                                                      .abs().max() / s).item())
                worst[dt][0] = max(worst[dt][0], f_err)
        log(f"[train-kernel] {name}: {len(calls[name])} train-step specs, "
            f"{sum(calls[name].values())} calls {counted}; forward max|diff| "
            f"f32 {worst[torch.float32][0]:.3e} bf16 "
            f"{worst[torch.bfloat16][0]:.3e}; backward max|diff| / max|grad| "
            f"f32 {worst[torch.float32][1]:.3e} bf16 "
            f"{worst[torch.bfloat16][1]:.3e} (vs autograd of the plain version)")


def phase_train_loop(train_ds, tmp):
    """``training.loop.train`` at VSRConfig() (bf16, warmup 2000, batch 4,
    crop 64) for WARM_TRAIN_STEPS + TIMED_TRAIN_STEPS steps, logging every
    LOG_EVERY: steps/s and frames/s of the timed steps from the loop's own
    log (host clock, data pipeline included), peak memory."""
    from video_super_resolution_tpu_torch.training.loop import train

    cfg = train_cfg(ckpt_dir=os.path.join(tmp, "loop"), log_every=LOG_EVERY,
                    ckpt_every=10 ** 9)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(cfg, train_ds, max_steps=WARM_TRAIN_STEPS + TIMED_TRAIN_STEPS)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(cfg.train.ckpt_dir, "train.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    timed = [r for r in logs if "steps_per_s" in r
             and r["step"] > WARM_TRAIN_STEPS]
    secs = sum(LOG_EVERY / r["steps_per_s"] for r in timed)
    sps = len(timed) * LOG_EVERY / secs
    log(f"[train-loop] training.loop.train, bf16 VSRConfig() batch "
        f"{TRAIN_BATCH} crop {TRAIN_CROP} (HR {4 * TRAIN_CROP}), steps "
        f"{WARM_TRAIN_STEPS + 1}-{WARM_TRAIN_STEPS + TIMED_TRAIN_STEPS}: "
        f"{sps:.3f} steps/s = {sps * TRAIN_BATCH:.3f} frames/s, host wall "
        f"{1e3 / sps:.3f} ms/step (host clock between the loop's logs, "
        f"data pipeline included); whole call {wall:.1f} s with "
        f"{WARM_TRAIN_STEPS} warm-up steps and one checkpoint; peak memory "
        f"{peak:.3f} GiB; last loss {timed[-1]['loss']:.5f}")
    if out["state"].step != WARM_TRAIN_STEPS + TIMED_TRAIN_STEPS:
        raise AssertionError("train() stopped at the wrong step")
    return out["state"], cfg, sps


def phase_train_profile(state, batch):
    """Steps on a batch already on the card: host wall a step (host clock
    around 10 steps ending in a synchronise), then one step under
    torch.profiler: device busy, idle share, device time by group."""
    from video_super_resolution_tpu_torch.tools.profile_prefix import (
        device_events,
        profiled,
    )
    from video_super_resolution_tpu_torch.training.step import make_train_step

    step = make_train_step()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    prof = profiled(lambda: step(state, batch), 1, torch.device("cuda"))
    evs = device_events(prof)
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    log("[train-profile] host time by op (self CPU ms, calls; profiled): "
        + "; ".join(f"{a.key} {a.self_cpu_time_total / 1e3:.3f} ({a.count})"
                    for a in host[:12])
        + f"; all ops {sum(a.self_cpu_time_total for a in host) / 1e3:.3f} ms")
    if not evs:
        log(f"[train-profile] host wall {wall:.3f} ms/step; the profiler "
            f"recorded no device events: busy and idle share not measured")
        return state
    start = min(e.time_range.start for e in evs)
    end = max(e.time_range.end for e in evs)
    busy = sum(e.time_range.end - e.time_range.start for e in evs)
    groups = collections.Counter()
    for e in evs:
        groups[kernel_group(e.name)] += e.time_range.end - e.time_range.start
    log(f"[train-profile] bf16 train step, device batch: host wall "
        f"{wall:.3f} ms/step (10 steps, host clock); one profiled step: "
        f"{len(evs)} device events, span {(end - start) / 1e3:.3f} ms, busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / (end - start):.4f}")
    for g, us in groups.most_common():
        log(f"[train-profile] {g}: {us / 1e3:.3f} ms ({us / busy:.4f} of busy)")
    names = collections.Counter()
    for e in evs:
        names[e.name[:70]] += e.time_range.end - e.time_range.start
    log("[train-profile] largest kernels: " + "; ".join(
        f"{n} {us / 1e3:.3f} ms" for n, us in names.most_common(10)))
    return state


def phase_checkpoint(state, cfg, tmp):
    """Save, restore into a fresh state: parameters and optimizer state
    bit-equal, the step restored; one more step from the restored state."""
    from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
    from video_super_resolution_tpu_torch.training.state import create_train_state

    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), keep=2)
    mgr.save(state.step, state, cfg)
    fresh = create_train_state(cfg, "cuda", seed=1)
    restored, at = mgr.restore(fresh)
    pa = dict(state.model.named_parameters())
    same = all(torch.equal(pa[n], p) for n, p in restored.model.named_parameters())
    sa = state.optimizer.state_dict()["state"]
    sb = restored.optimizer.state_dict()["state"]
    same_opt = sa.keys() == sb.keys() and all(
        sa[k]["step"] == sb[k]["step"] and torch.equal(sa[k]["exp_avg"], sb[k]["exp_avg"])
        and torch.equal(sa[k]["exp_avg_sq"], sb[k]["exp_avg_sq"]) for k in sa)
    cfg_back = mgr.restore_config()
    log(f"[checkpoint] saved step {state.step} ({os.path.getsize(mgr.path(state.step)) / 2 ** 20:.1f} "
        f"MiB), restored into a fresh state at step {at}: parameters "
        f"bit-equal {same}, optimizer state bit-equal {same_opt}, config "
        f"equal {cfg_back == cfg}")
    if not (same and same_opt and at == state.step == restored.step
            and cfg_back == cfg):
        raise AssertionError("checkpoint round trip is not exact")


def phase_eval(state, eval_ds):
    """evaluate_all on a synthetic clip with the trained bf16 model and the
    same weights in f32."""
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.evaluation.evaluate import evaluate_all

    m32 = api.build_model(train_cfg(compute_dtype="float32"), "cuda")
    m32.load_state_dict(state.model.state_dict())
    out = {}
    for tag, model in (("bf16", state.model), ("f32", m32)):
        avg = evaluate_all(api.eval_step, model, eval_ds)["__average__"]
        out[tag] = avg
        log(f"[eval] evaluate_all, {tag}, synthetic clip (5 frames, HR "
            f"256x256, Y, border 4): PSNR {avg['psnr']:.4f} dB, SSIM "
            f"{avg['ssim']:.5f} over {avg['frames']} frames")
        if not (math.isfinite(avg["psnr"]) and 0 < avg["ssim"] <= 1):
            raise AssertionError(f"eval {tag}: {avg}")
    log(f"[eval] bf16 - f32: {out['bf16']['psnr'] - out['f32']['psnr']:+.4f} dB")


def phase_train(kernels):
    import tempfile

    train_ds, eval_ds = train_data()
    batch = device_batch(next(train_ds.batches(TRAIN_BATCH)))
    phase_train_grads(kernels, batch)
    calls, launches = phase_train_fixed(kernels, batch)
    phase_train_kernels(kernels, calls)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        state, cfg, sps = phase_train_loop(train_ds, tmp)
        state = phase_train_profile(state, batch)
        phase_checkpoint(state, cfg, tmp)
    phase_eval(state, eval_ds)
    return {"launches": launches, "sps": sps, "state": state, "cfg": cfg,
            "calls": calls}


# ---------------------------------------- reference-era options at full width

def check_new_specs(kernels, calls, seen, tag):
    """Each argument spec of ``calls`` that ``seen`` lacks, held against its
    plain version and timed (check_spec); returns one summary a spec."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = []
    for name in ("conv3x3", "correlation", "warp"):
        for spec, n in sorted(calls[name].items(), key=lambda kv: str(kv[0])):
            if spec in seen[name]:
                continue
            r = check_spec(kernels, name, spec, n, gen)
            out.append({"kernel": name, "shape": list(spec[0]),
                        "dtype": str(spec[1])[6:], "extra": str(spec[2:]),
                        "calls": n, "max_abs_err": r["err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
            log(f"[{tag}] new spec: {json.dumps(out[-1])}")
    return out


def conv1_note(model):
    """The two_stage head's final conv (64 -> 3 at 2160x3840, f32): the
    port's tap-sum (``SmallOutConv``) against one F.conv2d on the same
    channels-last input, device time by CUDA-graph replay."""
    import torch.nn.functional as F

    conv = model.sr_head.Conv_1
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, 2160, 3840, 64), generator=gen, device="cuda")
    w, b = conv.weight.detach(), conv.bias.detach()
    xn = x.permute(0, 3, 1, 2)                  # channels-last view, no copy
    with torch.no_grad():
        err = (conv(x) - F.conv2d(xn, w, b, padding=1).permute(0, 2, 3, 1)
               ).abs().max().item()
        t_tap = graph_ms(lambda: conv(x))
        t_lib = graph_ms(lambda: F.conv2d(xn, w, b, padding=1))
    flops = 2 * x.numel() * 3 * 9
    nbytes = x.numel() * 4 + x.numel() // 64 * 3 * 4
    b_ms, b_by = bound_ms(flops, nbytes, torch.float32)
    log(f"[ref-era] sr_head.Conv_1 (1, 2160, 3840, 64) -> 3, f32: tap-sum "
        f"{t_tap:.4f} ms, F.conv2d {t_lib:.4f} ms (max|diff| {err:.3e}), bound "
        f"{b_ms:.4f} ms ({b_by})")
    del x, xn
    torch.cuda.empty_cache()


def phase_ref_era(kernels, seen, serving):
    """serving_config(warp_features=True, sr_head_style="two_stage") at full
    width: the forward through all three kernels (K1 with shuffle=True at
    540x960 and 1080x1920, K4 at C = 65), its new specs held and timed,
    Conv_1 at 4K, throughput and a profile against the espcn forward, and
    the f32 forward through the kernels against the plain path."""
    from video_super_resolution_tpu_torch import serving_config

    label = "reference-era (two_stage + warp_features)"
    cfg = serving_config(warp_features=True, sr_head_style="two_stage")
    model, window, calls, counts = phase_forward(kernels, cfg, label)
    shuffled = sorted((sp[0], sp[2]) for sp in calls["conv3x3"] if sp[7])
    wide = sorted(sp[0] for sp in calls["warp"] if sp[0][-1] == 65)
    log(f"[ref-era] conv3x3 calls with shuffle=True: {shuffled}; warp calls "
        f"at C = 65: {wide}")
    want = [((1, 540, 960, 64), 256), ((1, 1080, 1920, 64), 256)]
    if shuffled != want or wide != [(2, 544, 960, 65)]:
        raise AssertionError("the reference-era forward did not call K1 with "
                             "shuffle=True at 64 -> 256 on 540x960 and "
                             "1080x1920, or K4 at C = 65")
    specs = check_new_specs(kernels, calls, seen, "ref-era")
    conv1_note(model)
    tp = phase_throughput(model, window, label)
    phase_profile(model, window, label)
    log(f"[ref-era] {tp['median']:.3f} ms/frame against the espcn serving "
        f"forward's {serving['median']:.3f} in this run "
        f"({tp['median'] / serving['median']:.3f}x); peak memory "
        f"{tp['peak_gib']:.3f} GiB against {serving['peak_gib']:.3f}")
    del model
    torch.cuda.empty_cache()
    phase_f32(kernels, window, cfg, label)
    return calls, counts, specs


def phase_espcn_mid(kernels, seen, serving):
    """serving_config(sr_espcn_mid=256) (QUALITY.md's 4 x C) at full width:
    one bf16 forward through the kernels, its new K1 specs held and timed,
    ms/frame and a profiled forward."""
    from video_super_resolution_tpu_torch import serving_config

    label = "espcn_mid=256"
    model, window, calls, counts = phase_forward(
        kernels, serving_config(sr_espcn_mid=256), label)
    specs = check_new_specs(kernels, calls, seen, "espcn-mid")
    if not any(sp["kernel"] == "conv3x3" and sp["shape"][-1] == 256
               for sp in specs):
        raise AssertionError("espcn_mid=256: no conv at Cin 256")
    tp = phase_throughput(model, window, label)
    phase_profile(model, window, label)
    log(f"[espcn-mid] {tp['median']:.3f} ms/frame against the espcn serving "
        f"forward's {serving['median']:.3f} in this run")
    del model
    torch.cuda.empty_cache()
    return calls, counts, specs


# ------------------------------------------------ serving-path quality check

QUALITY_STEPS = 300


def phase_quality(kernels, seen):
    """The quality tool (``tools/quality_serving.py``) on its ``hard``
    variant at full width (depth branch at 1/4 res, so at crop 64 the
    hourglass runs from 16x64, W padded to a multiple of 64, down to 1x4):

    - one train step on a random batch, its argument specs recorded;
    - ``train`` for QUALITY_STEPS steps (the tool's clips and schedule);
    - the six held-out ``heval_*`` clips at full size (LR 288x512, batch 4
      windows) through ``serving`` (bf16) and ``f32_kernels`` (TF32 off):
      PSNR per clip and the delta bf16 - f32; every PSNR finite and every
      |delta| (per clip and on average) within TOLERANCE_DB;
    - counts set to 0 before the train and before each eval path, read
      after: each launches every kernel;
    - each spec of the train step and the eval forward that ``seen`` lacks,
      held against its plain version and timed (``check_new_specs``), the
      train step's also through its backward (``phase_train_kernels``);
      for each kernel and dtype their totals (calls x ms) a train step and
      a batch-4 eval forward.
    Returns the launches and the spec rows."""
    import tempfile

    from video_super_resolution_tpu_torch.tools import quality_serving as qs
    from video_super_resolution_tpu_torch.training.state import create_train_state
    from video_super_resolution_tpu_torch.training.step import make_train_step

    t_phase = time.perf_counter()
    cfg = qs.production_cfg("hard", QUALITY_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(8)
    crop = cfg.data.crop_size
    batch = {"lr": torch.rand((TRAIN_BATCH, 3, crop, crop, 3), generator=gen,
                              device="cuda"),
             "hr": torch.rand((TRAIN_BATCH, 4 * crop, 4 * crop, 3),
                              generator=gen, device="cuda")}
    train_calls = collections.defaultdict(collections.Counter)
    with kernels.recording(train_calls):
        make_train_step(cfg.train.charbonnier_eps)(
            create_train_state(cfg, "cuda", seed=0), batch)
    depth = sorted({sp[0][1:3] for sp in train_calls["conv3x3"]
                    if sp[0][1] < 16})
    log(f"[quality] hard train step: conv maps below 16 rows {depth}")

    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "hard")
        kernels.reset()
        rec = qs.train("hard", QUALITY_STEPS, run, log_every=100)
        torch.cuda.synchronize()
        train_launches = kernels.counts()
        log(f"[quality] train hard: {json.dumps(rec)}; launches "
            f"{train_launches}")
        t0 = time.perf_counter()
        ds = qs.eval_dataset("hard", cfg)
        log(f"[quality] six heval clips at HR {qs.EVAL_HR_H}x{qs.EVAL_HR_W}, "
            f"{qs.FRAMES} frames, made and degraded in "
            f"{time.perf_counter() - t0:.1f} s")
        eval_calls = collections.defaultdict(collections.Counter)
        records, eval_launches = {}, {}
        for path in qs.JUDGED:
            with kernels.recording(eval_calls):
                kernels.reset()
                records[path] = qs.evaluate_path(run, path, ds)
                torch.cuda.synchronize()
                eval_launches[path] = kernels.counts()
            log(f"[quality] {path}: PSNR {records[path]['psnr']:.4f} dB, SSIM "
                f"{records[path]['ssim']:.5f}, eval {records[path]['eval_s']:.1f}"
                f" s, launches {eval_launches[path]}")
        forwards = sum(math.ceil(ds.num_frames(c) / 4) for c in ds.clip_names)
        del ds
    for tag, counts in [("train", train_launches)] + list(eval_launches.items()):
        if min(counts.values()) <= 0:
            raise AssertionError(f"[quality] {tag} did not launch every "
                                 f"kernel: {counts}")
    bf, f32 = (records[p] for p in qs.JUDGED)
    pairs = {c: (bf["per_clip"][c]["psnr"], f32["per_clip"][c]["psnr"])
             for c in sorted(bf["per_clip"])}
    pairs["__average__"] = (bf["psnr"], f32["psnr"])
    for c, (a, b) in pairs.items():
        log(f"[quality] {c}: PSNR bf16 {a:.4f}, f32 {b:.4f} dB, delta "
            f"{a - b:+.6f} dB")
        if not (math.isfinite(a) and math.isfinite(b)
                and abs(a - b) <= qs.TOLERANCE_DB):
            raise AssertionError(f"[quality] {c}: bf16 {a} vs f32 {b} dB, "
                                 f"beyond {qs.TOLERANCE_DB} dB")

    fresh = collections.defaultdict(collections.Counter)
    for name, specs in train_calls.items():
        fresh[name].update({sp: n for sp, n in specs.items()
                            if sp not in seen[name]})
    phase_train_kernels(kernels, fresh)
    rows = check_new_specs(kernels, train_calls, seen, "quality")
    spec_totals("quality", "train step", rows)
    seen = {k: set(seen[k]) | set(train_calls[k]) for k in seen}
    per_forward = {k: collections.Counter({sp: n // forwards
                                           for sp, n in c.items()})
                   for k, c in eval_calls.items()}
    eval_rows = check_new_specs(kernels, per_forward, seen, "quality")
    spec_totals("quality", "eval forward", eval_rows)
    log(f"[quality] {len(rows) + len(eval_rows)} new specs held; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"train": train_launches, "eval": eval_launches,
            "specs": rows + eval_rows,
            "seen": {k: seen[k] | set(eval_calls[k]) for k in seen}}


def spec_totals(tag, where, rows):
    """One line a kernel and dtype: the new specs' count, sums of calls x
    (kernel, bound, plain, library) ms and the largest max|diff|."""
    groups = collections.defaultdict(list)
    for r in rows:
        groups[r["kernel"], r["dtype"]].append(r)
    for (name, dt), rs in sorted(groups.items()):
        tot = {k: sum(r["calls"] * r[k] for r in rs)
               for k in ("ms", "bound_ms", "plain_ms")}
        lib = (None if any(r["library_ms"] is None for r in rs)
               else sum(r["calls"] * r["library_ms"] for r in rs))
        log(f"[{tag}] totals, {where}: {name} {dt}: {len(rs)} new specs, "
            f"{sum(r['calls'] for r in rs)} calls; kernel {tot['ms']:.4f} ms, "
            f"bound {tot['bound_ms']:.4f}, plain {tot['plain_ms']:.4f}, "
            f"library {'null' if lib is None else f'{lib:.4f}'}; max|diff| "
            f"{max(r['max_abs_err'] for r in rs):.3e}")


# ------------------------------------- model-study tools: A/B and profiles

AB_STEPS = 20
AB_TOL_DB = 1e-5        # |PSNR card - PSNR CPU| a variant (PERF.md)
PROFILE_CALLS = 8       # calls a stage (profile_model) / forwards (prefix)
PREFIX_TOL = 0.01       # attributed share of the trace's device busy
NEW_RANGES = ("fd", "sr_trunk", "sr_skip", "sr_conv")


def phase_ab(kernels, seen):
    """The A/B tool (``tools/quality_ab.py``) on the card: each of its
    seven variants through ``run_variant`` (f32, TF32 off) for AB_STEPS
    steps on the tool's clips, counts set to 0 before and read after (each
    launches all three kernels); the trained weights evaluated on the
    held-out clips on the CPU through the plain versions, |PSNR card - PSNR
    CPU| within AB_TOL_DB; every argument spec of the runs that ``seen``
    lacks held against its plain version in f32 and bf16, forward and
    backward (``phase_train_kernels``), and timed (``check_new_specs``).
    Returns the launches by variant and the spec rows."""
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.tools import quality_ab as qa

    t0 = time.perf_counter()
    clips = qa.make_data()
    calls = collections.defaultdict(collections.Counter)
    launches, worst = {}, 0.0
    for name, overrides in qa.VARIANTS.items():
        cfg = qa.small_cfg(**overrides)
        with kernels.recording(calls):
            kernels.reset()
            rec, state = qa.run_variant(name, cfg, clips, AB_STEPS,
                                        log_every=AB_STEPS, emit=lambda s: None)
            torch.cuda.synchronize()
            launches[name] = kernels.counts()
        cpu_model = api.build_model(cfg, "cpu")
        cpu_model.load_state_dict(state.model.state_dict())
        cpu = qa.evaluate(cpu_model, qa.datasets(cfg, clips)[1])["__average__"]
        diff = rec["psnr"] - cpu["psnr"]
        log(f"[ab] {name}: {AB_STEPS} f32 steps + eval on the card in "
            f"{rec['train_s']:.2f} s, loss {rec['final_loss']:.6f}; PSNR card "
            f"{rec['psnr']:.6f} dB, CPU (plain versions, same weights) "
            f"{cpu['psnr']:.6f} dB, diff {diff:+.3e} dB; SSIM "
            f"{rec['ssim']:.6f} / {cpu['ssim']:.6f}; launches {launches[name]}")
        if not (math.isfinite(diff) and abs(diff) <= AB_TOL_DB):
            raise AssertionError(f"[ab] {name}: card - CPU PSNR {diff} dB "
                                 f"beyond {AB_TOL_DB}")
        if min(launches[name].values()) <= 0:
            raise AssertionError(f"[ab] {name} did not launch every kernel: "
                                 f"{launches[name]}")
        worst = max(worst, abs(diff))
        del state
    log(f"[ab] seven variants: max |PSNR card - CPU| {worst:.3e} dB "
        f"(limit {AB_TOL_DB})")
    fresh = collections.defaultdict(collections.Counter)
    for name, specs in calls.items():
        fresh[name].update({sp: n for sp, n in specs.items()
                            if sp not in seen[name]})
    phase_train_kernels(kernels, fresh, "in the runs")
    rows = check_new_specs(kernels, calls, seen, "ab")
    spec_totals("ab", f"7 variants x {AB_STEPS} steps + eval", rows)
    log(f"[ab] {len(rows)} new specs held; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "specs": rows}


def _finite_positive(lines, keys):
    return [r for r in lines for k in keys
            if not (isinstance(r.get(k), float) and math.isfinite(r[k])
                    and r[k] > 0)]


def launch_us(reps=2000):
    """Host us a launch of a one-element in-place add (host clock, no
    synchronisation inside the loop)."""
    x = torch.zeros(1, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        x.add_(1)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def forward_turns(fn_a, fn_b, pairs=5, reps=10):
    """Back-to-back ms a call (CUDA events, ``reps`` calls) of two setups
    in turns (a b, b a, ...): each one's median, min and max."""
    times = ([], [])
    for i in range(pairs):
        for j in ((0, 1) if i % 2 == 0 else (1, 0)):
            times[j].append(cuda_ms((fn_a, fn_b)[j], reps=reps))
    return [(statistics.median(t), min(t), max(t)) for t in times]


def host_costs(model, window):
    """The host cost of the model's four newest ranges: us a
    ``record_function`` enter and exit with no profiler running, and the
    bf16 540x960 forward with and without them, in turns (CUDA events);
    also us a launch of a tiny op. Returns the forward's median ms and
    the launch us, for comparison after the profiles."""
    import contextlib as cl

    from torch.profiler import record_function

    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.models import graphs, sr_head, vsr

    reps = 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        with record_function("fd"):
            pass
    us = (time.perf_counter() - t0) / reps * 1e6

    def without(name):
        return cl.nullcontext() if name in NEW_RANGES else graphs.stage(name)

    def run(ranges):
        def fn():
            vsr.stage = sr_head.stage = ranges
            try:
                api.upscale_window(model, window)
            finally:
                vsr.stage = sr_head.stage = graphs.stage
        return fn

    (a, a0, a1), (b, b0, b1) = forward_turns(run(graphs.stage), run(without))
    launch = launch_us()
    log(f"[profile-model] host costs before any profile in this process: "
        f"{us:.3f} us a record_function range (enter + exit, no profiler, "
        f"{reps} in a loop), so {len(NEW_RANGES) * us:.1f} us a forward for "
        f"the {len(NEW_RANGES)} new ranges {NEW_RANGES}; the forward with "
        f"them {a:.3f} ms (min {a0:.3f}, max {a1:.3f}), without {b:.3f} ms "
        f"(min {b0:.3f}, max {b1:.3f}) (medians of 5 x 10 back-to-back "
        f"forwards in turns, CUDA events): {a - b:+.3f} ms; a tiny op's "
        f"launch {launch:.2f} us (host clock)")
    return a, launch


def phase_profile_model():
    """``tools/profile_model.py`` at VSRConfig(), bf16, 540x960: every
    stage line printed, every JAX stage name present, each ``ms`` and
    ``host_ms`` finite and > 0. Before it (no profile has run in the
    process yet) the new ranges' host cost (``host_costs``); after its
    profiles the forward's back-to-back time and a launch's host cost
    again."""
    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.config import VSRConfig
    from video_super_resolution_tpu_torch.tools import profile_model as pm
    from video_super_resolution_tpu_torch.tools.profile_prefix import make_window

    t0 = time.perf_counter()
    cfg = VSRConfig()
    model = api.build_model(cfg, "cuda", seed=0)
    window = make_window(cfg, WINDOW[2], WINDOW[3]).cuda()
    before, launch_before = host_costs(model, window)
    lines = pm.run(WINDOW[2], WINDOW[3], PROFILE_CALLS, "cuda",
                   emit=lambda s: log(f"[profile-model] {s}"))
    missing = [n for n in pm.JAX_STAGES
               if n not in [r["stage"] for r in lines]]
    bad = _finite_positive(lines[:-1], ("ms", "host_ms"))
    if missing or bad:
        raise AssertionError(f"[profile-model] missing stages {missing}, "
                             f"bad times {bad}")
    ts = [cuda_ms(lambda: api.upscale_window(model, window), reps=10)
          for _ in range(5)]
    after, lo, hi = statistics.median(ts), min(ts), max(ts)
    log(f"[profile-model] after {len(lines) - 1} profiled stages: the forward "
        f"{after:.3f} ms back to back (median of 5 x 10, min {lo:.3f}, max "
        f"{hi:.3f}) against {before:.3f} before them; a tiny op's launch "
        f"{launch_us():.2f} us against {launch_before:.2f}")
    del model
    torch.cuda.empty_cache()
    log(f"[profile-model] phase {time.perf_counter() - t0:.1f} s")
    return lines


def phase_profile_prefix():
    """``tools/profile_prefix.py`` at VSRConfig(), bf16, 540x960: every
    line printed, every JAX prefix name present, each ``ms`` and ``host_ms``
    finite and > 0, and the stage deltas plus glue within PREFIX_TOL of the
    trace's device busy."""
    from video_super_resolution_tpu_torch.tools import profile_prefix as pp

    lines = pp.run(WINDOW[2], WINDOW[3], PROFILE_CALLS, "cuda",
                   emit=lambda s: log(f"[profile-prefix] {s}"))
    full = lines[-1]
    summed = sum(r["delta_ms"] for r in lines[:-1])
    missing = [n for n in pp.JAX_PREFIXES
               if n not in [r["prefix"] for r in lines]]
    bad = _finite_positive(lines, ("ms", "host_ms"))
    log(f"[profile-prefix] attribution {full['attribution']}: stage deltas + "
        f"glue {summed:.4f} ms of device busy {full['ms']:.4f} ms a forward "
        f"({summed / full['ms']:.5f}); unattributed "
        f"{full['unattributed_ms']:.4f} ms; largest stage difference to the "
        f"device-side spans {full['span_diff_ms']} ms")
    if missing or bad or abs(full["ms"] - summed) > PREFIX_TOL * full["ms"]:
        raise AssertionError(f"[profile-prefix] missing {missing}, bad times "
                             f"{bad}, or deltas {summed} ms vs busy "
                             f"{full['ms']} ms beyond {PREFIX_TOL}")
    return lines


# -------------------------------- host-path, scaling and ceiling tools

DISPATCH_STEPS, DISPATCH_K = 20, 4
DISPATCH_WARM = 2               # warm steps a Python-loop control (JAX: 20-40)
LOADER_WARMUP, LOADER_STEPS = 10, 20
LOADER_ALONE = (2, 8)           # loader-alone batches skipped, timed (JAX: 10, 200)
LOADER_ALONE_NATIVE = (200, 200)    # the cache warm (JAX's 200 timed)
LOADER_ALONE_COLD = (2, 40)
SCALING_SIZES = (1, 2)
SCALING_HW = (272, 480)         # SCALING.json's representative shape
SCALING_FPD = 2
ROOF_SHARE = 1.05               # most a measured rate may exceed a peak by


def phase_dispatch(kernels, clips):
    """``tools/bench_dispatch.py`` at VSRConfig(), ``--steps 20 --k 4``,
    DISPATCH_WARM warm steps a control, on PNG clips under ``clips``
    (each profiled trace holds every counted launch, or the tool raises):
    every control finite and > 0; counts
    set to 0 before each control and read after, and each launches every
    kernel; the fed controls on the native loader. Returns the launches by
    control."""
    from video_super_resolution_tpu_torch.tools import bench_dispatch as bd

    t0 = time.perf_counter()
    launches = {}

    @contextlib.contextmanager
    def around(name):
        torch.cuda.synchronize()
        kernels.reset()
        yield
        torch.cuda.synchronize()
        launches[name] = kernels.counts()

    rec = bd.run(DISPATCH_STEPS, DISPATCH_K, clips, "cuda", around=around,
                 warm=DISPATCH_WARM, emit=lambda s: log(f"[dispatch] {s}"))
    bad = [k for k, v in rec.items() if isinstance(v, float)
           and not (math.isfinite(v) and v > 0)]
    log(f"[dispatch] launches by control: {launches}; fed controls on the "
        f"{rec['loader']} loader; phase {time.perf_counter() - t0:.1f} s")
    if bad or len(launches) != 5 or min(
            n for c in launches.values() for n in c.values()) <= 0:
        raise AssertionError(f"[dispatch] bad numbers {bad} or a control "
                             f"without a kernel: {launches}")
    if rec["loader"] != "native":
        raise AssertionError(f"[dispatch] fed controls on {rec['loader']}")
    return launches


def phase_loader(clips):
    """``tools/bench_loader.py`` at ``--warmup 10 --steps 20``: ``--loader
    native`` with the frame cache on, the loader alone over
    LOADER_ALONE_NATIVE batches (the first of them fill the cache); the
    ``--loader python`` control at the same step counts, the loader alone
    over LOADER_ALONE batches (it runs ~2 batches/s); ``--loader native``
    cold, with ``VSR_LOADER_CACHE_MB=0`` set before the loader is created.
    Each record's ``loader`` must be the one asked for, its rates finite
    and > 0. Returns the records by run."""
    from video_super_resolution_tpu_torch.tools import bench_loader as bl

    t0 = time.perf_counter()
    runs = {"native": ("native", None, LOADER_ALONE_NATIVE),
            "python": ("python", None, LOADER_ALONE),
            "native cold": ("native", "0", LOADER_ALONE_COLD)}
    recs = {}
    for label, (loader, cache_mb, alone) in runs.items():
        old = os.environ.get("VSR_LOADER_CACHE_MB")
        if cache_mb is not None:
            os.environ["VSR_LOADER_CACHE_MB"] = cache_mb
        try:
            rec = bl.run(loader, LOADER_WARMUP, LOADER_STEPS, clips, "cuda",
                         loader_batches=alone,
                         emit=lambda s, label=label: log(f"[loader] {label}: {s}"))
        finally:
            if old is None:
                os.environ.pop("VSR_LOADER_CACHE_MB", None)
            else:
                os.environ["VSR_LOADER_CACHE_MB"] = old
        if rec["loader"] != loader or _finite_positive(
                [rec], ("loader_batches_per_s", "host_driven_steps_per_s",
                        "device_side_steps_per_s")):
            raise AssertionError(f"[loader] {label}: {rec}")
        recs[label] = rec
    log("[loader] batches/s alone; fed steps/s: " + "; ".join(
        f"{label} {r['loader_batches_per_s']:.3f}; "
        f"{r['host_driven_steps_per_s']:.3f}" for label, r in recs.items())
        + f" (device-side {recs['native']['device_side_steps_per_s']:.3f}); "
        f"phase {time.perf_counter() - t0:.1f} s")
    return recs


def phase_scaling():
    """``tools/bench_scaling.py`` at ``--sizes 1,2``, 272x480, 2 frames a
    rank, VSRConfig() bf16: each rank of each N launches every kernel; the
    N = 2 streamed frames against the unsharded model (what N = 1 runs) on
    the same frames in this process, each rank's windows as one batch, as
    the rank ran them, within the bf16 tolerance. Returns the launches by
    N and rank."""
    import numpy as np

    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.config import VSRConfig
    from video_super_resolution_tpu_torch.data.dataset import sliding_window_indices
    from video_super_resolution_tpu_torch.tools import bench_scaling as bs

    t0 = time.perf_counter()
    payload, outs = bs.run(SCALING_SIZES, *SCALING_HW, SCALING_FPD,
                           device="cuda", emit=lambda s: log(f"[scaling] {s}"))
    frames, streamed = outs[2]
    cfg = VSRConfig()
    model = api.build_model(cfg, "cuda", seed=0)
    t = len(frames)
    windows = torch.from_numpy(np.stack([
        frames[sliding_window_indices(t, c, cfg.model.window)]
        for c in range(t)])).cuda()
    with torch.no_grad():
        want = torch.cat([model(windows[i:i + SCALING_FPD])
                          for i in range(0, t, SCALING_FPD)])
    rtol, atol = TOL[torch.bfloat16]
    c = close(streamed, want, rtol, atol)
    launches = {r["time_axis"]: r["launches"] for r in payload["results"]}
    log(f"[scaling] {payload['backend']} on {payload['gpus']} GPU(s): N = 2 "
        f"streamed frames vs the unsharded model: max|diff| {c['err']:.3e} "
        f"(rtol/atol {rtol}); launches by N and rank {launches}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    del model, windows, want
    torch.cuda.empty_cache()
    if not c["ok"] or min(n for rs in launches.values() for r in rs
                          for n in r.values()) <= 0:
        raise AssertionError("[scaling] N = 2 differs from the unsharded "
                             "model or a rank did not launch every kernel")
    return launches


def phase_roofline(kernels, seen):
    """``tools/bench_roofline.py``: one line an op, no ``peak_share`` above
    ROOF_SHARE, the ``k1_`` rows launching the conv kernel (counts set to
    0 before, read after); the measured ceilings and each ``k1_`` row's
    share of ``F.conv2d``'s and the bf16 matmul's rate; each ``k1_`` spec
    that ``seen`` lacks held against its plain version in f32 and bf16 and
    timed (``check_new_specs``). Returns the conv launches and the rows."""
    from video_super_resolution_tpu_torch.tools import bench_roofline as br

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset()
    lines = br.run("cuda", emit=lambda s: log(f"[roofline] {s}"))
    torch.cuda.synchronize()
    counts = kernels.counts()
    by = {r["op"]: r for r in lines}
    names = [op.name for op in br.roofline_ops("cuda")]
    over = [r["op"] for r in lines if not r["peak_share"] <= ROOF_SHARE]
    mm = max(by[n]["tflops"] for n in names if n.endswith("_bf16"))
    f32 = by["matmul_8192_f32"]["tflops"]
    log(f"[roofline] measured ceilings: bf16 matmul {mm:.1f} TFLOP/s "
        f"({mm * 1e12 / PEAK_FLOPS[torch.bfloat16]:.3f} of 989), f32 matmul "
        f"{f32:.1f} ({f32 * 1e12 / PEAK_FLOPS[torch.float32]:.3f} of 67), "
        f"HBM (axpy) "
        f"{by['axpy_256MB_f32']['gbps']:.1f} GB/s "
        f"({by['axpy_256MB_f32']['gbps'] * 1e9 / HBM_BYTES_PER_S:.3f} of "
        f"3350), transpose {by['transpose_BHWC-BCHW']['gbps']:.1f} GB/s")
    for n in names:
        if n.startswith("k1_"):
            k, lib = by[n]["tflops"], by[n[3:]]["tflops"]
            log(f"[roofline] {n}: {k:.1f} TFLOP/s = {k / lib:.3f} of F.conv2d's "
                f"{lib:.1f}, {k / mm:.3f} of the bf16 matmul's")
    calls = collections.defaultdict(collections.Counter)
    for (b, h, w, ci, co) in br.SHAPES["conv"]:
        calls["conv3x3"][((b, h, w, ci), torch.bfloat16, co, 1, 1.0, None, 1,
                          False)] += 1
    rows = check_new_specs(kernels, calls, seen, "roofline")
    log(f"[roofline] {len(rows)} new specs held; conv3x3 launches "
        f"{counts['conv3x3']}; phase {time.perf_counter() - t0:.1f} s")
    if [r["op"] for r in lines] != names or over or counts["conv3x3"] <= 0:
        raise AssertionError(f"[roofline] lines {[r['op'] for r in lines]}, "
                             f"peak_share above {ROOF_SHARE}: {over}, "
                             f"launches {counts}")
    return {"launches": counts["conv3x3"], "specs": rows, "calls": calls}


AB_PSNR_DB = 40.0       # least PSNR of a bf16 A/B variant against kernel/kernel


def _finite_numbers(rec):
    """Every number of a record (nested dicts included) is finite."""
    vals = [v for v in rec.values() if not isinstance(v, (str, list))]
    return all(_finite_numbers(v) if isinstance(v, dict)
               else isinstance(v, (int, float)) and math.isfinite(v)
               for v in vals)


def phase_kernel_vs_library(kernels, seen, counts):
    """The kernel-against-library tools at their defaults, each under
    ``Kernels.recording`` (the tools' own call sites recorded too), counts
    set to 0 before each and read after:
    - ``tools/bench_conv.py --check``: K1 and ``conv3x3_library`` at the
      JAX tool's four shapes, bf16;
    - ``tools/bench_warp.py --check``: K4 and ``warp_library`` (f32 grid);
    - ``tools/bench_model_ab.py``: the four conv/warp variants of the bf16
      serving forward, interleaved.
    Every record finite, no ``error``; each ``max_abs_diff_vs_plain``
    within TOL's atol; each A/B variant launching per forward what the
    serving forward (``counts``) launches of the kernels it keeps and none
    of those it swaps; each bf16 variant's output >= AB_PSNR_DB against
    kernel/kernel's (the repo's PSNR: Y, border 4); the four variants in
    f32 (TF32 off) at 540x960 held against kernel/kernel at MODEL_TOL;
    each argument spec the tools gave that ``seen`` lacks held and timed
    (``check_new_specs``). Returns the launches by tool and the spec
    rows."""
    import numpy as np

    from video_super_resolution_tpu_torch import api, serving_config
    from video_super_resolution_tpu_torch.evaluation.metrics import psnr
    from video_super_resolution_tpu_torch.tools import bench_conv as bc
    from video_super_resolution_tpu_torch.tools import bench_model_ab as ab
    from video_super_resolution_tpu_torch.tools import bench_warp as bw
    from video_super_resolution_tpu_torch.utils.profiling import roofline_report

    t0 = time.perf_counter()
    calls = collections.defaultdict(collections.Counter)
    tool_sites = [(bc, "fused_conv3x3", "conv3x3"), (bw, "backward_warp", "warp")]
    outs, launches = {}, {}

    def emit(line):
        log(f"[kernel-vs-library] {line}")

    with kernels.recording(calls, tool_sites):
        conv_lines, launches["bench_conv"] = counted(
            kernels, lambda: bc.run(check=True, emit=emit))
        warp_lines, launches["bench_warp"] = counted(
            kernels, lambda: bw.run(check=True, emit=emit))
        ab_lines = ab.run(emit=emit, outputs=outs)
    bad = [r for r in conv_lines + warp_lines + ab_lines
           if "error" in r or not _finite_numbers(r)]
    if bad:
        raise AssertionError(f"[kernel-vs-library] failed or non-finite "
                             f"records: {bad}")
    # bench_conv's inputs are bf16, bench_warp's f32
    far = ([r for r in conv_lines if not r["max_abs_diff_vs_plain"]
            <= TOL[torch.bfloat16][1]]
           + [r for r in warp_lines if not r["max_abs_diff_vs_plain"]
              <= TOL[torch.float32][1]])
    by = {(r["impl"], tuple(r["shape"])): r for r in conv_lines}
    for (b, h, w, ci, co) in bc.SHAPES:
        k, lib = by["kernel", (b, h, w, ci, co)], by["library", (b, h, w, ci, co)]
        log(f"[kernel-vs-library] K1 {b}x{h}x{w}x{ci}->{co} bf16: kernel "
            f"{k['ms']:.4f} ms, library {lib['ms']:.4f} ms, floor "
            f"{k['floor_ms']:.4f} ms; library / kernel "
            f"{lib['ms'] / k['ms']:.3f}")
    log("[kernel-vs-library] " + roofline_report(
        {f"{r['impl']} conv3x3 {r['shape']}": (r["ms"], r["floor_ms"])
         for r in conv_lines}).replace("\n", "\n[kernel-vs-library] "))
    for r in warp_lines:
        if r["impl"] == "library":
            k = next(q for q in warp_lines if q["impl"] == "kernel"
                     and q["shape"] == r["shape"])
            log(f"[kernel-vs-library] K4 {r['shape']} f32: kernel "
                f"{k['ms']:.4f} ms, grid_sample (f32 grid) {r['ms']:.4f} ms, "
                f"bound {r['hbm_bound_ms']:.4f} ms; max|diff| vs plain "
                f"{k['max_abs_diff_vs_plain']:.3e} / "
                f"{r['max_abs_diff_vs_plain']:.3e}")
    wrong = {}
    for r in ab_lines:
        conv, warp = ab.parse_variant(r["variant"])
        per = {k: v / r["timed_forwards"] for k, v in r["launches"].items()}
        want = {"conv3x3": counts["conv3x3"] if conv == "kernel" else 0,
                "correlation": counts["correlation"],
                "warp": counts["warp"] if warp == "kernel" else 0}
        if per != want:
            wrong[r["variant"]] = (per, want)
        r["psnr_vs_first_db"] = psnr(*(outs[v].float().cpu().numpy() for v in
                                       (r["variant"], ab.VARIANTS[0])))
        log(f"[kernel-vs-library] A/B {r['variant']}: {r['ms_per_frame']:.3f} "
            f"ms/frame (median {r['median_ms']:.3f}, min {r['min_ms']:.3f}, "
            f"std {r['std_ms']:.3f}), device {r['device_ms_per_frame']:.3f} "
            f"ms/frame, launches a forward {per}, PSNR vs kernel/kernel "
            f"{r['psnr_vs_first_db']:.2f} dB, max|diff| "
            f"{r['max_abs_diff_vs_first']:.3e}")
    low = [r["variant"] for r in ab_lines if r["psnr_vs_first_db"] < AB_PSNR_DB]
    del outs
    # the four variants in f32 against each other
    cfg = serving_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                compute_dtype="float32"))
    model = api.build_model(cfg, "cuda", seed=0)
    x = torch.from_numpy(np.random.default_rng(0).random(WINDOW)).cuda().float()
    rtol, atol = MODEL_TOL
    ref = ab.variant_forward(ab.VARIANTS[0], model)(x)
    f32_bad = []
    for label in ab.VARIANTS[1:]:
        got = ab.variant_forward(label, model)(x)
        err = (got - ref).abs().max().item()
        log(f"[kernel-vs-library] f32 (TF32 off) {label} vs {ab.VARIANTS[0]} "
            f"at 540x960: max|diff| {err:.3e} (rtol {rtol}, atol {atol})")
        if not torch.allclose(got, ref, rtol=rtol, atol=atol):
            f32_bad.append(label)
        del got
    del model, ref, x
    torch.cuda.empty_cache()
    rows = check_new_specs(kernels, calls, seen, "kernel-vs-library")
    launches["model_ab"] = {r["variant"]: r["launches"] for r in ab_lines}
    log(f"[kernel-vs-library] {len(rows)} new specs held; launches "
        f"{launches}; phase {time.perf_counter() - t0:.1f} s")
    if far or wrong or low or f32_bad:
        raise AssertionError(
            f"[kernel-vs-library] beyond TOL's atol {far}; launches a "
            f"forward (got, want) {wrong}; below "
            f"{AB_PSNR_DB} dB {low}; f32 beyond MODEL_TOL {f32_bad}")
    return {"launches": launches, "specs": rows, "calls": calls}


# ------------------------------------------------------- the headline bench

BENCH_TIMEOUT_S = 300           # each bench process
# line: (arguments, metric, unit) at JAX's defaults (540x960, frames 16)
BENCH_LINES = {"serving": ([], "frames_per_sec_per_chip_540x960_to_x4",
                           "frames/s/chip"),
               "train": (["--train"], "train_steps_per_sec_b4_crop64",
                         "steps/s")}


def run_bench(argv):
    """``python -m video_super_resolution_tpu_torch.bench`` with ``argv``
    from the repo root: its last line as a dict and its wall seconds."""
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "video_super_resolution_tpu_torch.bench",
         *argv], cwd=ROOT, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S)
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        raise AssertionError(f"[bench] {argv}: rc {p.returncode}; stderr "
                             f"{p.stderr[-3000:]}")
    return json.loads(lines[-1]), time.perf_counter() - t0


def phase_bench(card, serving, counts):
    """The headline bench as a user runs it, one process a line: each
    line's metric and unit, a finite value > 0, ``device`` the card's
    nvidia-smi name and power limit; the serving line's ``out_shape``
    (phase 2's); each line's launches, a frame and a step, those of phase
    2's forward (``counts``: K1 / K3 / K4 59 / 4 / 4; the train step's
    backward launches none of them). Beside the
    serving line the bench's 1000 / value and phase 4's back-to-back
    median, printed only: no check rests on run-to-run noise. Returns
    each line's launches (a frame, a step)."""
    recs, bad = {}, []
    for name, (argv, metric, unit) in BENCH_LINES.items():
        rec, wall = run_bench(argv)
        recs[name] = rec
        log(f"[bench] {name} ({wall:.1f} s, its process): {json.dumps(rec)}")
        value = rec.get("value")
        if (rec.get("metric"), rec.get("unit")) != (metric, unit):
            bad.append(f"{name}: metric {rec.get('metric')!r}, unit "
                       f"{rec.get('unit')!r}")
        if not (isinstance(value, (int, float)) and math.isfinite(value)
                and value > 0):
            bad.append(f"{name}: value {value!r}")
        if rec.get("device") != card:
            bad.append(f"{name}: device {rec.get('device')!r} != {card!r}")
    serve = recs["serving"]
    if serve.get("out_shape") != [1, 4 * WINDOW[2], 4 * WINDOW[3], 3]:
        bad.append(f"serving: out_shape {serve.get('out_shape')}")
    for name, per in (("serving", "a frame"), ("train", "a step")):
        if recs[name].get("launches") != counts:
            bad.append(f"{name}: launches {per} {recs[name].get('launches')} "
                       f"!= the forward's {counts}")
    if bad:
        raise AssertionError(f"[bench] {bad}")
    log(f"[bench] serving {1000.0 / serve['value']:.3f} ms/frame by the "
        f"bench (3 chains of 16, mean minus the pull, host clock), "
        f"{serving['median']:.3f} ms/frame by chip_smoke's throughput "
        f"(median of {TIMED_FORWARDS} back-to-back forwards, CUDA events); "
        f"busy {serve['busy_ms_per_frame']:.3f} ms/frame, idle share "
        f"{serve['idle_share']:.3f}")
    return {name: rec["launches"] for name, rec in recs.items()}


# ------------------------------------------------ clip, CLI and checkpoints

def phase_probe():
    """What the native loader's build and the clip/CLI phases need, on this
    machine: one line; returns (PIL present, native loader buildable).
    The native loader needs g++ alone; png.h and libpng16 are shown for
    the record (the port uses neither)."""
    import ctypes.util
    import importlib.util
    import shutil

    from video_super_resolution_tpu_torch.data import native_loader

    gxx = shutil.which("g++")
    png_h = "not checked (no g++)" if not gxx else subprocess.run(
        [gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
        input="#include <png.h>\n", capture_output=True,
        text=True).returncode == 0
    missing = native_loader.missing()
    have = {"g++": gxx is not None, "png.h": png_h,
            "libpng16": ctypes.util.find_library("png16") is not None,
            "PIL": importlib.util.find_spec("PIL") is not None}
    log("[probe] " + ", ".join(
        f"{k}: {v if isinstance(v, str) else ('yes' if v else 'no')}"
        for k, v in have.items())
        + "; native loader "
        + ("buildable (g++ and the C++ standard library)" if not missing else
           f"unavailable (missing {', '.join(missing)})")
        + ("; clip and CLI phases run" if have["PIL"] else
           "; clip and CLI phases not run (no PIL to read and write PNGs)"))
    return have["PIL"], not missing


PNG_SMALL = (96, 160)
PNG_BENCH = {"frames": 2, "h": 1080, "w": 1920, "reps": 3}


def phase_png(tmp):
    """The port's PNG decoder (``data/native_loader.decode_png``, the
    decoder of ``csrc/png_decode.h``) on PNGs that PIL writes: RGB, RGBA,
    L and P with a transparent index, each bit-equal to PIL's bytes x
    float32(1/255), the C code's ``byte * (1/255.f)``; then
    ``tools/bench_png.py`` on 1080x1920 frames (PNG_BENCH): the port and
    PIL, bit-equal, ms a frame on the host."""
    import numpy as np
    from PIL import Image

    from video_super_resolution_tpu_torch.data import native_loader
    from video_super_resolution_tpu_torch.data.synthetic import detail_clip
    from video_super_resolution_tpu_torch.tools import bench_png

    t0 = time.perf_counter()
    inv = np.float32(1.0 / 255.0)
    h, w = PNG_SMALL
    rgb = (detail_clip(1, h, w, seed=3)[0] * 255.0 + 0.5).astype(np.uint8)
    alpha = np.linspace(0, 255, w, dtype=np.uint8)[None, :, None].repeat(h, 0)
    images = {"RGB": Image.fromarray(rgb),
              "RGBA": Image.fromarray(np.concatenate([rgb, alpha], -1), "RGBA"),
              "L": Image.fromarray(rgb).convert("L"),
              "P+tRNS": Image.fromarray(rgb).quantize(colors=64)}
    bad = []
    for name, im in images.items():
        path = os.path.join(tmp, f"{name}.png")
        im.save(path, **({"transparency": 3} if name == "P+tRNS" else {}))
        got = native_loader.decode_png(path)
        with Image.open(path) as back:
            want = np.asarray(back.convert("RGB")) * inv
        equal = got.shape == want.shape and np.array_equal(got, want)
        log(f"[png] {name} {h}x{w}: {got.shape}, bit-equal to PIL: {equal}")
        if not equal:
            bad.append(name)
    rec = bench_png.run(**PNG_BENCH, root=os.path.join(tmp, "bench"),
                        emit=lambda s: log(f"[png] bench_png: {s}"))
    ms = rec["ms_per_frame"]
    log(f"[png] {rec['h']}x{rec['w']}, {rec['bytes_per_frame']} bytes a file: port "
        f"{ms['port']:.3f} ms/frame, PIL {ms['pil']:.3f} (host {rec['host']}); "
        f"bit-equal: {rec['equal']}; phase {time.perf_counter() - t0:.1f} s")
    if bad or not rec["equal"]:
        raise AssertionError(f"[png] decodes differ from PIL: {bad}, "
                             f"bench_png equal: {rec['equal']}")


def write_clip(directory, frames):
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray((f.clip(0, 1) * 255.0 + 0.5).astype("uint8")).save(
            os.path.join(directory, f"{i:04d}.png"))


def cli_json(argv):
    import io

    from video_super_resolution_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return json.loads(buf.getvalue()) if buf.getvalue().strip() else None


def phase_clip_cli(tmp, train_sps):
    """A 5-frame 540x960 PNG clip through ``api.upscale_clip`` (equal to
    ``eval_step`` on each window) and ``cli infer``; ``cli train`` at
    VSRConfig() for 20 steps on HR-only 256x256 PNG clips (the native
    loader, whose compact batches decode on the card), ``cli eval`` on its
    checkpoint, ``cli import-weights`` on a saved state_dict."""
    import numpy as np
    from PIL import Image

    from video_super_resolution_tpu_torch import api, serving_config
    from video_super_resolution_tpu_torch.data import synthetic as syn
    from video_super_resolution_tpu_torch.data.dataset import (
        list_clips,
        load_frame,
        sliding_window_indices,
    )

    lr_root, hr_root = os.path.join(tmp, "lr"), os.path.join(tmp, "hr")
    write_clip(os.path.join(lr_root, "clip"),
               syn.moving_gradient_clip(5, 540, 960, 2.0, -1.0, seed=5)[0])
    write_clip(os.path.join(hr_root, "smooth"),
               syn.moving_gradient_clip(7, 256, 256, 2.0, -1.0, seed=6)[0])
    write_clip(os.path.join(hr_root, "detail"), syn.detail_clip(7, 256, 256, seed=7))

    clip = np.stack([load_frame(p) for p in list_clips(lr_root)["clip"]])
    model = api.build_model(serving_config(), "cuda", seed=0)
    api.eval_step(model, torch.from_numpy(clip[None, :3]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hr = api.upscale_clip(model, clip)
    secs = time.perf_counter() - t0
    equal = all(np.array_equal(hr[c], api.eval_step(model, torch.from_numpy(
        clip[sliding_window_indices(5, c, 3)][None]))[0].cpu().numpy())
        for c in range(5))
    log(f"[clip] api.upscale_clip, bf16 serving, 5 frames 540x960 -> "
        f"{tuple(hr.shape)}: {5 / secs:.3f} frames/s (host clock, copies to "
        f"the host included); equal to eval_step on each window: {equal}")
    if not equal or hr.shape != (5, 2160, 3840, 3):
        raise AssertionError("upscale_clip differs from per-window eval_step")
    del model, hr
    torch.cuda.empty_cache()

    ck = os.path.join(tmp, "cli_ckpt")
    t0 = time.perf_counter()
    cli_json(["train", "--hr-root", hr_root, "--ckpt-dir", ck, "--steps",
              "20", "--set", "train.log_every=10", "train.ckpt_every=20"])
    secs = time.perf_counter() - t0
    with open(os.path.join(ck, "train.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    native = logs[0].get("native_loader")
    sps = [r["steps_per_s"] for r in logs if "steps_per_s" in r]
    log(f"[cli] train, VSRConfig() bf16, 20 steps on HR-only 256x256 PNG "
        f"clips: native_loader {native}; steps/s {[round(v, 3) for v in sps]} "
        f"(steps 1-10 with warm-up, 11-20) against the in-memory "
        f"training.loop.train's {train_sps:.3f} steps/s (train phase); call "
        f"{secs:.1f} s")
    if native != 1.0 or len(sps) != 2:
        raise AssertionError(f"cli train log: {logs}")

    res = cli_json(["eval", "--hr-root", hr_root, "--ckpt-dir", ck])
    avg = res["__average__"]
    log(f"[cli] eval at step {res['step']}: PSNR {avg['psnr']:.4f} dB, SSIM "
        f"{avg['ssim']:.5f} over {avg['frames']} frames")
    if res["step"] != 20 or not math.isfinite(avg["psnr"]) or avg["frames"] != 14:
        raise AssertionError(f"cli eval: {res}")

    out = os.path.join(tmp, "out")
    t0 = time.perf_counter()
    cli_json(["infer", "--lr-root", lr_root, "--out-dir", out, "--ckpt-dir", ck])
    secs = time.perf_counter() - t0
    files = sorted(os.listdir(os.path.join(out, "clip")))
    sizes = {Image.open(os.path.join(out, "clip", f)).size for f in files}
    log(f"[cli] infer: {len(files)} PNGs of {sizes} in {secs:.1f} s (model "
        f"build, restore, 5 forwards, PNG encoding)")
    if len(files) != 5 or sizes != {(3840, 2160)}:
        raise AssertionError("cli infer did not write 5 frames of 3840x2160")

    sd = torch.load(os.path.join(ck, "ckpt_20.pt"), map_location="cpu",
                    weights_only=True)["model"]
    path = os.path.join(tmp, "weights.pth")
    torch.save({"state_dict": sd}, path)
    shapes = cli_json(["import-weights", "--torch-ckpt", path])
    ok = shapes == {k: list(v.shape) for k, v in sd.items()}
    log(f"[cli] import-weights: {len(shapes)} tensors, shapes as saved: {ok}")
    if not ok:
        raise AssertionError("cli import-weights shapes differ")


def phase_async_checkpoint(state, cfg, tmp):
    """An asynchronous save of the trained VSRConfig() state: the time
    ``save`` blocks (the host copy) against ``wait()`` (the write); the
    parameters are changed right after ``save``, and the restore is still
    bit-equal to the state at ``save``."""
    from video_super_resolution_tpu_torch.training.checkpoint import CheckpointManager
    from video_super_resolution_tpu_torch.training.state import create_train_state

    mgr = CheckpointManager(os.path.join(tmp, "async"), keep=2)
    want = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state.step, state, cfg)
    t_save = time.perf_counter() - t0
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    t0 = time.perf_counter()
    mgr.wait()
    t_wait = time.perf_counter() - t0
    restored, at = mgr.restore(create_train_state(cfg, "cuda", seed=1))
    got = restored.model.state_dict()
    same = all(torch.equal(got[k], v) for k, v in want.items())
    changed = not torch.equal(state.model.state_dict()[next(iter(want))],
                              want[next(iter(want))])
    size = os.path.getsize(mgr.path(at)) / 2 ** 20
    log(f"[async-ckpt] save of step {at} ({size:.1f} MiB): save() blocked "
        f"{t_save * 1e3:.1f} ms (copy to host memory), wait() {t_wait * 1e3:.1f} "
        f"ms (the writer's torch.save and rename); parameters changed after "
        f"save: {changed}; restore bit-equal to the state at save: {same}")
    if not (same and changed and at == state.step):
        raise AssertionError("async checkpoint restore is not the state at save")


# ------------------------------------------------------------ parallel modes

PAR_CLIP = 8            # frames of the world-size-1 stream_upscale timing
PAR_REPS = 3            # bf16 calls timed a mode
MODES = ("temporal", "space", "tp", "dp", "sp")


def host_ms(fn, reps):
    """Host-clock ms a call of fn() (its device work synchronised), after
    one warm-up call; None when reps is 0."""
    if not reps:
        return None
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def counted(kernels, fn):
    """fn() and the kernels it launched: every count set to 0 just before,
    read just after."""
    torch.cuda.synchronize()
    kernels.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.counts()


def close(got, want, rtol, atol):
    got = torch.as_tensor(got).float().cpu()
    want = torch.as_tensor(want).float().cpu()
    return {"err": float((got - want).abs().max()),
            "ok": bool(torch.allclose(got, want, rtol=rtol, atol=atol))}


def parallel_modes(inputs, device):
    """A case of ``parallel/launch.py`` (run in this process at world size
    1, and by each rank of a job as ``"chip_smoke:parallel_modes"``):
    every mode on meshes of the world's size, each on every rank against
    the unsharded model (f32, TF32 off: "config", "train_config"), with
    the kernels each launched on this rank, and bf16 times ("reps" calls,
    host clock) of the sharded form, and on rank 0 of the unsharded one:

    - temporal: ``stream_upscale`` of "frames" on time = world, against
      ``upscale_clip`` (the stream clipped to [0, 1] as it is);
    - space: the same on space = world (time 1 x space world);
    - tp: ``make_tp_forward`` of "window" on model = world, against the
      forward; "tp_allreduce_ms": one all-reduce of a block's partial sum
      ("allreduce_shape", f32) over the model group;
    - dp: one train step on "batch" on data = world (each rank its slice),
      against one step on the whole batch (loss, grad_norm at rtol 1e-5);
    - sp: the same on space = world.

    Forwards at rtol = atol = 1e-4."""
    import torch.distributed as dist

    from video_super_resolution_tpu_torch import api
    from video_super_resolution_tpu_torch.config import MeshConfig, VSRConfig
    from video_super_resolution_tpu_torch.parallel.launch import local_batch
    from video_super_resolution_tpu_torch.parallel.tensor import make_tp_forward
    from video_super_resolution_tpu_torch.runtime.mesh import (
        AXIS_MODEL,
        all_reduce_sum_,
        build_mesh,
    )
    from video_super_resolution_tpu_torch.training.state import create_train_state
    from video_super_resolution_tpu_torch.training.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = Kernels()
    world, rank0 = dist.get_world_size(), dist.get_rank() == 0
    reps = inputs.get("reps", 0)
    cfg = VSRConfig.from_json(inputs["config"])
    tcfg = VSRConfig.from_json(inputs["train_config"])
    bf16 = lambda c: c.replace(train=dataclasses.replace(  # noqa: E731
        c.train, compute_dtype="bfloat16"))
    metrics = lambda m: {k: float(v) for k, v in m.items()}  # noqa: E731
    frames, window = inputs["frames"], inputs["window"].to(device)
    model, fast = (api.build_model(c, device, 0) for c in (cfg, bf16(cfg)))
    out, transport = {}, collections.Counter()
    clip = api.upscale_clip(model, frames)
    for name, axis in (("temporal", "time"), ("space", "space")):
        mesh = build_mesh(MeshConfig(**{axis: world}), device)
        got, n = counted(kernels, lambda: api.stream_upscale(model, frames,
                                                             cfg, mesh))
        out[name] = {"launches": n, **close(got.clip(0, 1), clip, 1e-4, 1e-4),
                     "ms": host_ms(lambda: api.stream_upscale(
                         fast, frames, bf16(cfg), mesh), reps)}
        if rank0:
            out[name]["plain_ms"] = host_ms(
                lambda: api.upscale_clip(fast, frames), reps)
        transport.update(mesh.transport)

    mesh = build_mesh(MeshConfig(model=world), device)
    got, n = counted(kernels, lambda: make_tp_forward(model, mesh)(window))
    tp = make_tp_forward(fast, mesh)
    part = torch.randn(inputs["allreduce_shape"], device=device)
    out["tp"] = {"launches": n,
                 **close(got, api.upscale_window(model, window), 1e-4, 1e-4),
                 "ms": host_ms(lambda: tp(window), reps),
                 "tp_allreduce_ms": host_ms(
                     lambda: all_reduce_sum_(part, mesh, AXIS_MODEL), reps)}
    if rank0:
        out["tp"]["plain_ms"] = host_ms(lambda: api.upscale_window(fast, window),
                                        reps)
    transport.update(mesh.transport)

    eps = tcfg.train.charbonnier_eps
    for name, mcfg in (("dp", MeshConfig(data=world)),
                       ("sp", MeshConfig(space=world))):
        mesh = build_mesh(mcfg, device)
        state = create_train_state(tcfg, device, 0)
        step = make_train_step(eps, mesh)
        (_, m), n = counted(kernels, lambda: step(
            state, local_batch(inputs["batch"], mesh)))
        _, want = make_train_step(eps)(create_train_state(tcfg, device, 0),
                                       inputs["batch"])
        m, want = metrics(m), metrics(want)
        fast_state = create_train_state(bf16(tcfg), device, 0)
        out[name] = {"launches": n, **m, "want": want, "ok": all(
            abs(m[k] - want[k]) <= 1e-5 * abs(want[k])
            for k in ("loss", "grad_norm")), "ms": host_ms(lambda: step(
                fast_state, local_batch(inputs["batch"], mesh)), reps)}
        if rank0:
            plain = make_train_step(eps)
            out[name]["plain_ms"] = host_ms(
                lambda: plain(fast_state, inputs["batch"]), reps)
        transport.update(mesh.transport)
    out["transport"] = [[*k, v] for k, v in sorted(transport.items())]
    return out


def parallel_inputs():
    """The ``parallel_modes`` case's inputs at full width: serving_config()
    f32 (4 frames and one window of 540x960) and VSRConfig() f32 (warmup
    0, a batch of 4 windows, LR crop 64), from seeded generators."""
    from video_super_resolution_tpu_torch import serving_config

    g = torch.Generator().manual_seed(11)
    h, w = WINDOW[2:4]
    return {"cases": ["chip_smoke:parallel_modes"],
            "config": serving_config().replace(train=dataclasses.replace(
                serving_config().train, compute_dtype="float32")).to_json(),
            "train_config": train_cfg(compute_dtype="float32",
                                      warmup_steps=0).to_json(),
            "frames": torch.rand((4, h, w, 3), generator=g),
            "window": torch.rand(WINDOW, generator=g),
            "batch": {"lr": torch.rand((TRAIN_BATCH, 3, TRAIN_CROP, TRAIN_CROP,
                                        3), generator=g),
                      "hr": torch.rand((TRAIN_BATCH, 4 * TRAIN_CROP,
                                        4 * TRAIN_CROP, 3), generator=g)},
            "reps": PAR_REPS, "allreduce_shape": [1, h, w, 64]}


def report_modes(tag, results):
    """Log and check the ``parallel_modes`` results of every rank: in each
    mode every rank launched all three kernels and its comparison with the
    unsharded model holds."""
    r0 = results[0]
    for mode in MODES:
        ranks = [r[mode] for r in results]
        line = (f"[parallel] {tag} {mode}: launches "
                f"{[r['launches'] for r in ranks]}; ")
        if mode in ("dp", "sp"):
            line += "; ".join(
                f"rank {i} loss {r['loss']:.7f} / unsharded "
                f"{r['want']['loss']:.7f}, grad_norm {r['grad_norm']:.7f} / "
                f"{r['want']['grad_norm']:.7f}" for i, r in enumerate(ranks))
            line += " (rtol 1e-5)"
        else:
            errs = ", ".join(f"{r['err']:.3e}" for r in ranks)
            line += f"max|diff| vs unsharded by rank [{errs}] (rtol/atol 1e-4)"
        line += (f"; bf16 {[round(r['ms'], 3) for r in ranks]} ms a call by "
                 f"rank vs unsharded {r0[mode]['plain_ms']:.3f} (host clock, "
                 f"{PAR_REPS} calls)")
        if mode == "tp":
            line += (f"; one block's partial-sum all-reduce (1, 540, 960, 64) "
                     f"f32 {r0[mode]['tp_allreduce_ms']:.3f} ms")
        log(line)
        for i, r in enumerate(ranks):
            if not r["ok"]:
                raise AssertionError(f"[parallel] {tag} {mode}: rank {i} "
                                     f"differs from the unsharded model")
            if min(r["launches"].values()) <= 0:
                raise AssertionError(f"[parallel] {tag} {mode}: rank {i} did "
                                     f"not launch a kernel: {r['launches']}")
    log(f"[parallel] {tag} collectives (op, backend, transport, calls) on "
        f"rank 0: {r0['transport']}")


def stream_vs_clip(kernels, mesh):
    """bf16 serving, a PAR_CLIP-frame 540x960 clip: ms/frame of
    ``api.stream_upscale`` (its windows in one batched forward) against
    ``api.upscale_clip`` (a forward a frame), host clock with the copies to
    the host, in turns clip, stream, stream, clip; the stream's launches."""
    from video_super_resolution_tpu_torch import api, serving_config

    cfg = serving_config()
    model = api.build_model(cfg, "cuda", seed=0)
    clip = torch.rand((PAR_CLIP, *WINDOW[2:4], 3),
                      generator=torch.Generator().manual_seed(12))
    runs = {"clip": lambda: api.upscale_clip(model, clip),
            "stream": lambda: api.stream_upscale(model, clip, cfg, mesh)}
    for fn in runs.values():
        fn()
    times = collections.defaultdict(list)
    for name in ("clip", "stream", "stream", "clip"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / PAR_CLIP * 1e3)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset()
    runs["stream"]()
    torch.cuda.synchronize()
    counts = kernels.counts()
    log(f"[parallel] world 1 (NCCL), bf16 {PAR_CLIP}-frame 540x960 clip: "
        f"stream_upscale {times['stream']} ms/frame, upscale_clip "
        f"{times['clip']} ms/frame (host clock, copies to the host "
        f"included); stream peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; launches "
        f"{counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"stream_upscale did not launch every kernel: "
                             f"{counts}")
    del model
    torch.cuda.empty_cache()
    return counts


def tp_conv_specs(kernels):
    """The conv shapes the TP trunk brings at n = 2 and 4 model ranks
    (C = 64): conv1 64 -> 128/n with the LReLU, conv2 128/n -> 64 at slope
    1 with no residual (its bias added after the all-reduce), bf16 at
    540x960, each held against the plain version and timed
    (check_spec)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    xs = (1, *WINDOW[2:4])
    out = []
    for n in (2, 4):
        for name, cin, cout, slope in (("conv1", 64, 128 // n, 0.1),
                                       ("conv2", 128 // n, 64, 1.0)):
            spec = (xs + (cin,), torch.bfloat16, cout, 1, slope, None, 1, False)
            r = check_spec(kernels, "conv3x3", spec, 5, gen)
            out.append({"n": n, "conv": name, "cin": cin, "cout": cout,
                        **{k: r[k] for k in ("err", "ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "bound_by")}})
            log(f"[parallel] TP {name} at n = {n}: {json.dumps(out[-1])}")
    return out


GLOO_PROBE_OPS = ("all_reduce", "all_gather", "exchange")


def gloo_probe(inputs, device):
    """A case of ``parallel/launch.py`` (``"chip_smoke:gloo_probe"``): the
    collective "op" between the job's 2 ranks, issued straight to the
    process group on CUDA tensors of ``device``, with no host copies;
    whether it delivered the right values. A collective gloo cannot carry
    on the device aborts the rank's process instead."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    x = torch.full((4, 1024), float(rank + 1), device=device)
    op = inputs["op"]
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = bool((x == world * (world + 1) / 2).all())
    elif op == "all_gather":
        got = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(got, x)
        ok = all(bool((g == i + 1).all()) for i, g in enumerate(got))
    else:       # runtime.mesh.exchange_neighbors' send and receive
        peer, got = 1 - rank, torch.empty_like(x)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                            dist.P2POp(dist.irecv, got, peer)]):
            work.wait()
        ok = bool((got == peer + 1).all())
    torch.cuda.synchronize()
    return {"ok": ok}


def probe_gloo(tmp):
    """Which collectives gloo carries for CUDA tensors itself: each of
    GLOO_PROBE_OPS in its own 2-rank gloo job on cuda:0 (an abort ends only
    that job). Those it does not carry must be exactly the ones
    ``runtime/mesh.py`` hands gloo host copies of (``_GLOO_HOST_STAGED``),
    else the run fails, after every op is probed."""
    from video_super_resolution_tpu_torch.parallel import launch
    from video_super_resolution_tpu_torch.runtime import mesh as rm

    wrong = []
    for op in GLOO_PROBE_OPS:
        t0 = time.perf_counter()
        try:
            res = launch.spawn({"cases": ["chip_smoke:gloo_probe"], "op": op},
                               2, os.path.join(tmp, f"probe_{op}"),
                               device="cuda:0", backend="gloo", timeout=90)
            carried = all(r["chip_smoke:gloo_probe"]["ok"] for r in res)
            how = "delivered" if carried else "wrong values"
        except RuntimeError as e:       # the job's failure is the finding
            carried = False
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            how = "failed: " + " | ".join(
                [lines[0]] + [ln.strip() for ln in lines if "rror" in ln][-2:])
        staged = op in rm._GLOO_HOST_STAGED
        log(f"[parallel] gloo probe, {op} of CUDA tensors on cuda:0 "
            f"({time.perf_counter() - t0:.1f} s): {how}; runtime/mesh.py "
            f"{'stages it through host copies' if staged else 'hands gloo the CUDA tensors'}")
        if carried == staged:
            wrong.append(op)
    if wrong:
        raise AssertionError(f"runtime/mesh.py routes {wrong} of CUDA tensors "
                             f"under gloo against what the probe found")


def phase_parallel(kernels, tmp):
    """The parallel modes at full width, each against the unsharded model
    on the card and with its kernel launches counted on every rank:

    - world size 1, NCCL, in this process (``initialize_distributed``):
      the ``parallel_modes`` case (temporal and spatial streaming of 4
      frames, the TP forward, the dp and the sp train step, f32 with TF32
      off against the unsharded forms, bf16 times beside them), then bf16
      ``stream_upscale`` against ``upscale_clip`` on an 8-frame clip;
    - the gloo probe (``probe_gloo``): which collectives gloo carries for
      CUDA tensors, against ``runtime/mesh.py``'s routes;
    - 2 processes, gloo, both ranks on cuda:0 (NCCL takes one GPU a rank):
      the same case at world size 2; the compute stays on the card, the
      collectives go as ``runtime/mesh.py`` routes them (printed);
    - the TP conv shapes at n = 2 and 4, held and timed.
    Returns the launches of the world-1 stream and of each mode."""
    import torch.distributed as dist

    from video_super_resolution_tpu_torch.config import MeshConfig
    from video_super_resolution_tpu_torch.parallel import launch
    from video_super_resolution_tpu_torch.parallel.spatial import (
        halo_rows,
        strip_rows,
    )
    from video_super_resolution_tpu_torch.runtime import mesh as rm

    t_phase = time.perf_counter()
    inputs = parallel_inputs()
    rm.initialize_distributed(f"localhost:{launch.free_port()}", 1, 0,
                              device="cuda:0")
    try:
        log(f"[parallel] world 1: process group backend "
            f"{dist.get_backend()}")
        one = parallel_modes(inputs, "cuda:0")
        report_modes("world 1 (NCCL)", [one])
        stream = stream_vs_clip(kernels, rm.build_mesh(MeshConfig(), "cuda:0"))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    probe_gloo(tmp)
    t0 = time.perf_counter()
    two = [r["chip_smoke:parallel_modes"] for r in launch.spawn(
        inputs, 2, os.path.join(tmp, "parallel"), device="cuda:0",
        backend="gloo", timeout=600)]
    log(f"[parallel] 2 ranks (gloo) on cuda:0: job {time.perf_counter() - t0:.1f} "
        f"s (start, kernel load, every mode); correctness runs: two ranks "
        f"share one card, so their times say nothing about scaling")
    report_modes("2 ranks (gloo, one card)", two)

    from video_super_resolution_tpu_torch import api, serving_config

    halo = halo_rows(api.build_model(serving_config(), "cpu"))
    plan = strip_rows(WINDOW[2], 2, halo, 544)
    log(f"[parallel] spatial strips at space 2: halo {halo} LR rows; "
        + "; ".join(f"rank {i} owns rows {s.r0}-{s.r1} and computes "
                    f"{s.lo}-{s.hi} ({(s.hi - s.lo) / (s.r1 - s.r0):.4f}x "
                    f"its rows in encode and fusion)"
                    for i, s in enumerate(plan)))
    specs = tp_conv_specs(kernels)
    log(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s")
    return {"stream": stream,
            "modes": {m: [one[m]["launches"]] + [r[m]["launches"] for r in two]
                      for m in MODES}, "tp_specs": specs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import tempfile

    from video_super_resolution_tpu_torch import serving_config

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    card = phase_build()
    kernels = Kernels()
    model, window, calls, counts = phase_forward(kernels, serving_config())
    rows = phase_kernels(kernels, calls, counts)
    serving = phase_throughput(model, window)
    bench = phase_bench(card, serving, counts)
    phase_profile_model()
    phase_profile_prefix()
    have_pil, native_ok = phase_probe()
    if not native_ok:
        raise AssertionError("[probe] the native loader cannot be built")
    with tempfile.TemporaryDirectory() as tools_tmp:
        phase_png(tools_tmp)
        clips = os.path.join(tools_tmp, "clips")
        dispatch = phase_dispatch(kernels, clips)
        phase_loader(clips)
    scaling = phase_scaling()
    roof = phase_roofline(kernels, {k: set(calls[k]) for k in calls})
    kvl = phase_kernel_vs_library(
        kernels, {k: set(calls[k]) | set(roof["calls"][k]) for k in calls},
        counts)
    phase_profile(model, window)
    del model
    torch.cuda.empty_cache()
    phase_f32(kernels, window, serving_config())
    ref_calls, ref_counts, ref_specs = phase_ref_era(kernels, calls, serving)
    seen = {k: set(calls[k]) | set(ref_calls[k]) | set(roof["calls"][k])
            | set(kvl["calls"][k]) for k in calls}
    mid_calls, mid_counts, mid_specs = phase_espcn_mid(kernels, seen, serving)
    train = phase_train(kernels)
    seen = {k: seen[k] | set(mid_calls[k]) | set(train["calls"][k])
            for k in seen}
    quality = phase_quality(kernels, seen)
    ab = phase_ab(kernels, quality["seen"])
    with tempfile.TemporaryDirectory() as tmp:
        if have_pil:
            phase_clip_cli(tmp, train["sps"])
        phase_async_checkpoint(train["state"], train["cfg"], tmp)
        del train["state"]
        torch.cuda.empty_cache()
        par = phase_parallel(kernels, tmp)
    for row in rows:
        name = row["name"]
        row["train_step_launches"] = train["launches"][name]
        row["ref_era_launches"] = ref_counts[name]
        row["espcn_mid_launches"] = mid_counts[name]
        row["new_specs"] = [sp for sp in ref_specs + mid_specs
                            + quality["specs"] + ab["specs"] + roof["specs"]
                            + kvl["specs"] if sp["kernel"] == name]
        row["dispatch_launches"] = {c: n[name] for c, n in dispatch.items()}
        row["scaling_launches"] = {n: [r[name] for r in ranks]
                                   for n, ranks in scaling.items()}
        row["quality_train_launches"] = quality["train"][name]
        row["quality_eval_launches"] = {p: c[name] for p, c in
                                        quality["eval"].items()}
        row["ab_launches"] = {v: c[name] for v, c in ab["launches"].items()}
        row["parallel_stream_launches"] = par["stream"][name]
        row["parallel_mode_launches"] = {
            m: [c[name] for c in counts] for m, counts in par["modes"].items()}
        row["bench_launches"] = {line: n[name] for line, n in bench.items()}
        row["bench_conv_launches"] = kvl["launches"]["bench_conv"][name]
        row["bench_warp_launches"] = kvl["launches"]["bench_warp"][name]
        row["model_ab_launches"] = {v: c[name] for v, c in
                                    kvl["launches"]["model_ab"].items()}
        if name == "conv3x3":
            row["tp_specs"] = par["tp_specs"]
            row["roofline_launches"] = roof["launches"]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

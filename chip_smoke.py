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
   beside the plain version, one PyTorch library call where one computes
   the same function (F.conv2d, F.grid_sample), and the least time the card
   could take (bytes / 3.35 TB/s vs FLOP / peak rate). Two times are
   printed for each: "host-incl." is CUDA events around back-to-back
   wrapper calls, which at small shapes measures the wrapper's host path;
   "device" is CUDA events around the replay of a CUDA graph that captured
   GRAPH_CALLS calls, which runs the same kernels with no host work
   between them (warm L2 in both). The per-forward totals of the
   ``{"kernels": ...}`` line (ms, plain_ms, library_ms) are device times.
   For conv3x3 also its tile plan (staging route, pixel tile, split-K
   factor) and its rate as a share of the peak;
4. throughput: median and p75 per-forward time of 40 back-to-back bf16
   forwards (CUDA events), frames/s, peak device memory; then one forward
   under torch.profiler for device time by kernel group and idle share;
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

- probe: one line saying whether g++, png.h, libpng16 and PIL exist; the
  native loader is built when g++ and png.h do, and the clip and CLI
  phase runs when PIL does (it reads and writes PNGs);
- clip and CLI: a 5-frame 540x960 PNG clip through ``api.upscale_clip``,
  which must equal ``eval_step`` on each window (frames/s); ``cli train``
  at ``VSRConfig()`` for 20 steps on HR-only 256x256 PNG clips (its log's
  ``native_loader`` must be 1 when the native loader is buildable, else 0;
  steps/s beside phase 6's in-memory loop), ``cli eval`` and ``cli infer``
  (5 PNGs of 3840x2160) on its checkpoint, ``cli import-weights`` on a
  saved state_dict;
- async checkpoint: the time ``save`` blocks against ``wait()``; the
  parameters are changed right after ``save`` and the restore is still
  bit-equal to the state at ``save``.

The last two lines are the ``{"kernels": [...]}`` summary (per-forward
totals over the serving forward's specs; ``launches`` counts the serving
forward, ``train_step_launches`` one train step, ``ref_era_launches`` and
``espcn_mid_launches`` the two option forwards, ``new_specs`` the option
forwards' new argument specs with their times) and
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
STAGES = ("flow", "depth", "warp", "encode", "fusion", "sr")
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
    def patched(self, make):
        """Replace each call site's function by make(name, original)."""
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in self.sites]
        try:
            for mod, attr, name in self.sites:
                setattr(mod, attr, make(name, self.wrappers[name]))
            yield
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def recording(self, calls):
        """Call sites go through the kernels; calls[name] counts each call's
        argument spec."""
        def make(name, fn):
            sig = inspect.signature(fn)

            def rec(*args, **kw):
                bound = sig.bind(*args, **kw)
                bound.apply_defaults()
                calls[name][spec_of(name, bound.arguments)] += 1
                return fn(*args, **kw)
            return rec
        return self.patched(make)

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
    model's modules hand it over, and the plain version as OIHW."""
    import torch.nn.functional as F

    from video_super_resolution_tpu_torch.ops.fused_conv import prepare_conv3x3_weight
    from video_super_resolution_tpu_torch.utils.profiling import (
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
        wl, bl = wt.to(dtype), bias.to(dtype)
        xn = x.permute(0, 3, 1, 2)
        lib = lambda: F.conv2d(xn, wl, bl, padding=d, dilation=d)  # noqa: E731
        flops = 2 * b * h * w * cout * 9 * cin
        nbytes = (x.numel() * x.element_size() + wl.numel() * wl.element_size()
                  + cout * 4 + b * h * w * cout * x.element_size()
                  + (0 if r is None else r.numel() * r.element_size()))
        return args, plain_args, lib, flops, nbytes
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
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xg = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    grid = torch.stack([(xg + flow[..., 0]) * 2 / max(w - 1, 1) - 1,
                        (ys + flow[..., 1]) * 2 / max(h - 1, 1) - 1], -1)
    imn = img.permute(0, 3, 1, 2)
    grid = grid.to(dtype)
    lib = lambda: F.grid_sample(imn, grid, mode="bilinear",  # noqa: E731
                                padding_mode=mode, align_corners=True)
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
    wrapper and of F.conv2d at the smallest recorded shape, where the
    device work is least: what the forward's host path pays per conv."""
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
        f"call, F.conv2d {host_us(lib):.1f} us (host clock, {reps} calls)")


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
    from torch.profiler import ProfilerActivity, profile

    from video_super_resolution_tpu_torch import api

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        api.eval_step(model, window)
        torch.cuda.synchronize()
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
    stages = collections.Counter()
    for e in prof.events():
        if (e.name in STAGES and e.device_type == torch.autograd.DeviceType.CUDA
                and e.time_range.end > e.time_range.start):
            stages[e.name] += e.time_range.end - e.time_range.start
    log("[profile] stage spans on the device (record_function ranges): "
        + ("; ".join(f"{n} {stages[n] / 1e3:.3f} ms" for n in STAGES
                     if n in stages) or "not recorded"))


def device_events(prof):
    """The device's kernels and copies in a profile (not the ranges that
    annotate them on the device's timeline, e.g. the optimizer's step)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.time_range.end > e.time_range.start]


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


def phase_train_kernels(kernels, calls):
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
            f"{sum(calls[name].values())} calls a step; forward max|diff| "
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
    from torch.profiler import ProfilerActivity, profile

    from video_super_resolution_tpu_torch.training.step import make_train_step

    step = make_train_step()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
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
    return {"launches": launches, "sps": sps, "state": state, "cfg": cfg}


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


# ------------------------------------------------ clip, CLI and checkpoints

def phase_probe():
    """What the native loader's build and the clip/CLI phases need, on this
    machine: one line; returns (PIL present, native loader buildable)."""
    import ctypes.util
    import importlib.util
    import shutil

    from video_super_resolution_tpu_torch.data import native_loader

    missing = native_loader.missing()
    gxx = shutil.which("g++") is not None
    have = {"g++": gxx,
            "png.h": "not checked (no g++)" if not gxx else not missing,
            "libpng16": ctypes.util.find_library("png16") is not None,
            "PIL": importlib.util.find_spec("PIL") is not None}
    log("[probe] " + ", ".join(
        f"{k}: {v if isinstance(v, str) else ('yes' if v else 'no')}"
        for k, v in have.items())
        + "; native loader "
        + ("buildable" if not missing else
           f"unavailable (missing {', '.join(missing)}): the CLI trains on "
           f"the Python loader")
        + ("; clip and CLI phases run" if have["PIL"] else
           "; clip and CLI phases not run (no PIL to read and write PNGs)"))
    return have["PIL"], not missing


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


def phase_clip_cli(tmp, train_sps, native_ok):
    """A 5-frame 540x960 PNG clip through ``api.upscale_clip`` (equal to
    ``eval_step`` on each window) and ``cli infer``; ``cli train`` at
    VSRConfig() for 20 steps on HR-only 256x256 PNG clips (native loader
    when buildable), ``cli eval`` on its checkpoint, ``cli import-weights``
    on a saved state_dict."""
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
    if native != float(native_ok) or len(sps) != 2:
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
    phase_profile(model, window)
    del model
    torch.cuda.empty_cache()
    phase_f32(kernels, window, serving_config())
    ref_calls, ref_counts, ref_specs = phase_ref_era(kernels, calls, serving)
    seen = {k: set(calls[k]) | set(ref_calls[k]) for k in calls}
    _, mid_counts, mid_specs = phase_espcn_mid(kernels, seen, serving)
    train = phase_train(kernels)
    have_pil, native_ok = phase_probe()
    with tempfile.TemporaryDirectory() as tmp:
        if have_pil:
            phase_clip_cli(tmp, train["sps"], native_ok)
        phase_async_checkpoint(train["state"], train["cfg"], tmp)
    for row in rows:
        name = row["name"]
        row["train_step_launches"] = train["launches"][name]
        row["ref_era_launches"] = ref_counts[name]
        row["espcn_mid_launches"] = mid_counts[name]
        row["new_specs"] = [sp for sp in ref_specs + mid_specs
                            if sp["kernel"] == name]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving entry points of the port.

- ``build_model``: the VSR model, or BasicVSR for a ``BasicVSRConfig``,
  with random weights from a seed (or load weights carried from the JAX
  package with ``weights.from_jax_params``).
- ``upscale_window``: (B, T, h, w, 3) LR window -> (B, 4h, 4w, 3).
- ``eval_step``: the same forward, f32 output clipped to [0, 1]; on a CUDA
  model, replayed from CUDA graphs once a call repeats the previous call's
  input shape, dtype and weights (``release_graphs`` frees them).
- ``upscale_clip``: (T, h, w, 3) frames -> (T, 4h, 4w, 3), one window
  a frame through ``eval_step``; a BasicVSR model takes the clip whole
  (its frame c depends on every frame), uploaded once.
- ``estimate_and_align``: flow of each neighbor onto the reference and the
  warped neighbors.
- ``stream_upscale``: a clip through the time (and space) sharded
  streaming program over a mesh (``parallel/streaming.py``).

``upscale_clip`` writes each HR frame once into its slot of one clip
array, allocated when the first frame's shape is known, through
``runtime/hostmem.py``: once a caller has dropped an earlier clip whose
block fits, the clip takes that block, its pages already faulted, in place
of fresh pages that fault on the write. On a CUDA model a
frame goes through one of two reused pinned host buffers: its copy off the
device is queued on the current stream behind its forward, and the host
moves it into the clip only after it has issued the next frame's forward,
so the copy overlaps the host's work. On a CPU model each frame is written
straight into its slot.

``upscale_clip`` and ``eval_step`` run inside ``torch.profiler``
``record_function`` ranges, one request's host work under one
``upscale_clip`` range: ``upscale_clip.gather`` (a frame's window on the
host), ``eval_step.upload``, ``eval_step.forward`` (the host's issue of the
model and the clamp; the model's own ranges nest inside),
``upscale_clip.stage`` (the queued copy into a pinned buffer; on the CPU
the write into the clip) and ``upscale_clip.copy_back`` (the wait for a
staged frame and its write into the clip; after the next frame's forward
where there is one). The whole-clip route has no gather and no
``eval_step``: ``upscale_clip.upload`` (the clip's one upload), then the
model's ranges and each frame's ``stage`` and ``copy_back``. Without an
active profiler a range costs a few us.
``upscale_clip.frames`` and ``upscale_clip.bytes_back`` count the HR frames
returned and their bytes copied off the model's device, and
``upscale_clip.frames_staged`` those that went through a pinned buffer,
and ``upscale_clip.frames_recycled`` those written into a recycled block,
``upscale_clip.whole_clips`` the clips served whole and
``upscale_clip.state_bytes`` the bytes of backward state the model held
for them, summed, profiler or not; ``eval_step.calls``,
``eval_step.replays`` and ``eval_step.captures`` count the calls, those
that replayed CUDA graphs and those that captured them first. A replay runs
each graph inside the model's ranges it was captured in, below
``eval_step.forward``.

They run on the CUDA device unless the caller passes ``device="cpu"``;
without a GPU a CUDA request raises instead of running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from video_super_resolution_tpu_torch.config import BasicVSRConfig, VSRConfig
from video_super_resolution_tpu_torch.data.dataset import sliding_window_indices
from video_super_resolution_tpu_torch.models import graphs
from video_super_resolution_tpu_torch.models.basicvsr import BasicVSR
from video_super_resolution_tpu_torch.models.common import init_params, pad_to_multiple
from video_super_resolution_tpu_torch.models.flow_net import FlowNet
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.ops.warp import backward_warp
from video_super_resolution_tpu_torch.runtime import hostmem
from video_super_resolution_tpu_torch.runtime.dtypes import DTypePolicy

Device = Union[str, torch.device]


def resolve_device(device: Device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the GPU "
                           "unless device='cpu' is passed")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_model(cfg: Union[VSRConfig, BasicVSRConfig, None] = None,
                device: Device = "cuda", seed: int = 0
                ) -> Union[VSRModel, BasicVSR]:
    """The model of ``cfg`` (a ``VSRModel``, or a ``BasicVSR`` for a
    ``BasicVSRConfig``) in its compute dtype, weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in eval mode on ``device``."""
    dev = resolve_device(device)
    cfg = cfg or VSRConfig()
    if isinstance(cfg, BasicVSRConfig):
        policy = DTypePolicy.from_strings(cfg.compute_dtype)
        model = BasicVSR(cfg, dtype=policy.compute_dtype)
    else:
        policy = DTypePolicy.from_strings(cfg.train.compute_dtype)
        model = VSRModel(cfg.model, dtype=policy.compute_dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def _device_of(model: torch.nn.Module) -> torch.device:
    return resolve_device(next(model.parameters()).device)


@torch.no_grad()
def upscale_window(model: VSRModel, window: torch.Tensor,
                   return_aux: bool = False):
    """(B, T, h, w, 3) LR window -> (B, h*scale, w*scale, 3) f32."""
    return model(window.to(_device_of(model)), return_aux=return_aux)


@torch.no_grad()
def eval_step(model: VSRModel, lr: torch.Tensor) -> torch.Tensor:
    """Forward, f32 prediction clipped to [0, 1]: a fresh tensor that no
    later call overwrites. On a CUDA model the forward replays CUDA graphs
    once a call repeats the previous call's key (``models/graphs.py``)."""
    counts = _EVAL_STEP
    counts.calls += 1
    run = graphs.graphed(model)
    with record_function("eval_step.upload"):
        lr, mode = run.upload(model, lr, _device_of(model))
    with record_function("eval_step.forward"):
        pred = run.forward(model, lr, mode)
        del lr
        out = pred.to(torch.float32).clamp(0.0, 1.0)
    if mode in ("capture", "replay"):
        counts.replays += 1
    if mode == "capture":
        counts.captures += 1
    return out


eval_step.calls = 0      # calls
eval_step.replays = 0    # of those, calls whose forward replayed CUDA graphs
eval_step.captures = 0   # of those, calls that captured the graphs first
_EVAL_STEP = eval_step   # the counters' owner, whatever rebinds ``eval_step``


def release_graphs(model: VSRModel) -> None:
    """Free the CUDA graphs ``eval_step`` captured for ``model`` and their
    memory pool; its next call at the same key runs eagerly again."""
    graphs.release(model)


class _ClipOut:
    """The clip a request returns and the HR frames' way into it: one
    array, allocated through ``runtime/hostmem.py`` when the first frame's
    shape is known. On a CUDA model a frame is queued into one of two
    pinned buffers behind its forward (``stage``) and written into its slot
    by ``drain``, which the caller runs after it has issued the next
    frame's forward; on a CPU model ``stage`` writes the slot itself."""

    def __init__(self, t: int, dev: torch.device):
        self.t = t
        self.staged = dev.type == "cuda"
        self.stream = torch.cuda.current_stream(dev) if self.staged else None
        self.clip = self.slots = self.recycled = None
        self.done = [None, None]     # a staged frame's copy-finished event

    def stage(self, c: int, hr: torch.Tensor) -> None:
        """Frame c of the clip, hr (1, sH, sW, 3) f32 on the device."""
        if self.clip is None:
            self.clip, self.recycled = hostmem.empty(
                (self.t,) + tuple(hr.shape[1:]), np.float32)
            if self.staged:
                self.slots = [torch.empty(hr.shape[1:], dtype=torch.float32,
                                          pin_memory=True)
                              for _ in range(min(self.t, 2))]
        with record_function("upscale_clip.stage"):
            if self.staged:
                # queued behind the forward on its stream, so the stream
                # reuses hr's device block only after the copy
                self.slots[c % 2].copy_(hr[0], non_blocking=True)
                self.done[c % 2] = torch.cuda.Event()
                self.done[c % 2].record(self.stream)
            else:
                torch.from_numpy(self.clip[c]).copy_(hr[0])

    def drain(self, c: int) -> None:
        """Wait for frame c's copy and write it into its slot."""
        with record_function("upscale_clip.copy_back"):
            if self.staged:
                self.done[c % 2].synchronize()
                torch.from_numpy(self.clip[c]).copy_(self.slots[c % 2])
                upscale_clip.frames_staged += 1
        upscale_clip.frames += 1
        upscale_clip.bytes_back += self.clip[c].nbytes
        upscale_clip.frames_recycled += self.recycled


def upscale_clip(model: Union[VSRModel, BasicVSR],
                 frames: Union[np.ndarray, torch.Tensor],
                 edge_mode: str = "replicate") -> np.ndarray:
    """(T, h, w, 3) frames -> (T, h*scale, w*scale, 3) f32 in [0, 1]: frame
    c is ``eval_step`` of the window ``sliding_window_indices(T, c, window,
    edge_mode)`` around it, as the JAX package's ``upscale_clip``; for a
    ``BasicVSR`` model, frame c of the model over the whole clip
    (``_upscale_whole_clip``; ``edge_mode`` is not read). Its per-frame
    buffers are freed inside its ``upscale_clip`` range."""
    if isinstance(model, BasicVSR):
        return _upscale_whole_clip(model, frames)
    with record_function("upscale_clip"):
        frames = torch.as_tensor(frames)
        t = frames.shape[0]
        if t == 0:
            raise ValueError("upscale_clip needs at least one frame")
        out = _ClipOut(t, _device_of(model))
        for c in range(t):
            with record_function("upscale_clip.gather"):
                idx = sliding_window_indices(t, c, model.cfg.window, edge_mode)
                lr = frames[idx][None]
            # each buffer is dropped as soon as it is used: the device frame
            # before the next frame's forward allocates its own
            hr = eval_step(model, lr)
            del lr
            out.stage(c, hr)
            del hr
            if c:
                out.drain(c - 1)
        out.drain(t - 1)
    return out.clip


@torch.no_grad()
def _upscale_whole_clip(model: BasicVSR,
                        frames: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    """``upscale_clip`` of a recurrent model, whose frame c depends on every
    frame of the clip: the clip uploaded once, then HR frame c, clipped to
    [0, 1], staged as soon as the model's forward pass yields it. The
    model holds its backward states for the whole clip
    (``upscale_clip.state_bytes``)."""
    with record_function("upscale_clip"):
        frames = torch.as_tensor(frames)
        t = frames.shape[0]
        if t == 0:
            raise ValueError("upscale_clip needs at least one frame")
        dev = _device_of(model)
        with record_function("upscale_clip.upload"):
            clip = frames.to(dev, torch.float32)
        out = _ClipOut(t, dev)
        for c, hr in enumerate(model.frames(clip)):
            out.stage(c, hr.clamp_(0.0, 1.0))
            del hr
            if c:
                out.drain(c - 1)
        del clip
        out.drain(t - 1)
        upscale_clip.whole_clips += 1
        upscale_clip.state_bytes += model.state_bytes
    return out.clip


upscale_clip.frames = 0          # HR frames returned
upscale_clip.bytes_back = 0      # bytes of those frames copied off the device
upscale_clip.frames_staged = 0   # of those, frames that went through a pinned buffer
upscale_clip.frames_recycled = 0  # of those, frames written into a recycled block
upscale_clip.whole_clips = 0     # clips served whole by a recurrent model
upscale_clip.state_bytes = 0     # bytes of backward state held for those


def build_flow_net(cfg: Optional[VSRConfig] = None, device: Device = "cuda",
                   seed: int = 0) -> FlowNet:
    """A standalone f32 FlowNet (for ``estimate_and_align``), built as the
    JAX package's ``estimate_and_align`` and ``init_flow_params`` build it
    (``video_super_resolution_tpu/api.py:57-64,79-85``): they pass no
    ``finest_level``, so it is FlowNet's default 1 whatever
    ``cfg.model.flow_finest_level`` says, and their flow parameters load
    here."""
    dev = resolve_device(device)
    cfg = cfg or VSRConfig()
    m = cfg.model
    net = FlowNet(pyramid_channels=m.pyramid_channels,
                  estimator_channels=m.flow_estimator_channels,
                  context_channels=m.context_channels,
                  max_displacement=m.max_displacement, slope=m.lrelu_slope)
    init_params(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()


@torch.no_grad()
def estimate_and_align(flow_net: FlowNet, ref: torch.Tensor,
                       neighbors: torch.Tensor, padding_mode: str = "zeros"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ref (B, H, W, 3), neighbors (B, N, H, W, 3) -> (flows (B, N, H, W, 2),
    warped neighbors (B, N, H, W, 3))."""
    dev = _device_of(flow_net)
    ref, neighbors = ref.to(dev), neighbors.to(dev)
    b, n, h0, w0, _ = neighbors.shape
    mult = 2 ** flow_net.levels
    ref_p, _ = pad_to_multiple(ref, mult)
    nbr_p, _ = pad_to_multiple(neighbors, mult)
    h, w = ref_p.shape[1:3]
    ref_rep = ref_p[:, None].expand(b, n, h, w, 3).reshape(b * n, h, w, 3)
    nbr_flat = nbr_p.reshape(b * n, h, w, 3)
    flows = flow_net(ref_rep, nbr_flat)
    warped = backward_warp(nbr_flat.contiguous(), flows.contiguous(),
                           padding_mode)
    flows = flows.reshape(b, n, h, w, 2)[:, :, :h0, :w0]
    warped = warped.reshape(b, n, h, w, 3)[:, :, :h0, :w0]
    return flows, warped


def stream_upscale(model: VSRModel, frames: Union[np.ndarray, torch.Tensor],
                   cfg: VSRConfig, mesh, window_batch: Optional[int] = None
                   ) -> np.ndarray:
    """(T, h, w, 3) frames -> (T, h*scale, w*scale, 3) on every rank of
    ``mesh`` (a ``runtime.mesh.Mesh``): timeline-sharded streaming
    inference, each time rank on its T / time frames, the model's
    unclipped f32 output as the JAX package's ``stream_upscale``."""
    from video_super_resolution_tpu_torch.parallel.streaming import (
        make_streaming_program,
        stream_clip,
    )

    t, h, w, _ = frames.shape
    time_size = mesh.shape.get("time", 1)
    if t % time_size:
        raise ValueError(f"frames {t} not divisible by time axis {time_size}")
    program = make_streaming_program(cfg, mesh, (h, w), t // time_size,
                                     window_batch)
    return stream_clip(program, model, frames, mesh)

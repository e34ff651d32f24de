"""The model's stage ranges, and its forward replayed from CUDA graphs
captured range by range.

``stage(name)`` is the ``torch.profiler.record_function`` range each stage
of the model runs in (``models/vsr.py``, ``models/sr_head.py``). While
``GraphedForward`` captures a forward, every entry to and exit from a stage
is also a segment boundary: the stretch of the forward captured since the
last boundary becomes one ``torch.cuda.CUDAGraph`` that remembers the
range path it ran in (("sr", "sr_trunk") for the SR trunk), and the next
stretch is captured into a new graph. A stretch that issued no device work
ends no graph: it takes the path of the next one instead. All the graphs
of one forward share one memory pool and replay in the order they were
captured, each inside the ranges of its path, so a profile attributes the
replayed kernels to the same stages as the eager forward's, and each
kernel wrapper's ``launches`` counter rises by the launches its segments'
capture counted (the counters count kernels run, not launch calls).

``GraphedForward`` decides from what it can observe. A call replays only
when the model is on a CUDA device, grad is disabled or nothing the
forward reads requires it, and the call's key (the input's shape and
dtype, every parameter's and buffer's ``_version`` and ``data_ptr``, and
the TF32 switches the library calls read) equals the previous call's. The
first call at a new key runs eagerly, on the stream the capture will use
(it builds the conv modules' prepared weights, the resize tables and the
libraries' workspaces that the capture then reads), the second captures
and replays, later ones replay. One graph set a model: a new key
frees the old set first. The replayed input is the set's own buffer, which
``upload`` fills; the output is the set's own too, overwritten by the next
replay. A replay reruns the captured kernels as they were: what the key
does not hold, such as a call site swapped for another function between
calls, it does not see (the tools that swap call sites call the model
directly).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import warnings
import weakref
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from video_super_resolution_tpu_torch.ops import _build
from video_super_resolution_tpu_torch.ops.correlation import correlation
from video_super_resolution_tpu_torch.ops.fused_conv import fused_conv3x3
from video_super_resolution_tpu_torch.ops.warp import backward_warp

# the kernel wrappers whose ``launches`` a replay advances
COUNTED = (fused_conv3x3, correlation, backward_warp)

_local = threading.local()      # .capture: the _Capture running on this thread


def _launches() -> Tuple[int, ...]:
    return tuple(fn.launches for fn in COUNTED)


def _set_launches(counts: Tuple[int, ...]) -> None:
    for fn, n in zip(COUNTED, counts):
        fn.launches = n


@contextlib.contextmanager
def stage(name: str):
    """The model's range ``name``; while a forward is captured, also a
    segment boundary on entry and on exit."""
    cap = getattr(_local, "capture", None)
    with record_function(name):
        if cap is None:
            yield
            return
        cap.move(cap.path + (name,))
        yield
        cap.move(cap.path[:-1])


class Segment(NamedTuple):
    """One captured stretch of the forward: the range path it ran in, its
    graph, and the launches of each ``COUNTED`` wrapper it holds."""

    path: Tuple[str, ...]
    graph: torch.cuda.CUDAGraph
    launches: Tuple[int, ...]


class _Capture:
    """The segments of one forward being captured on ``stream`` into
    ``pool``."""

    def __init__(self, pool, stream: torch.cuda.Stream):
        self.pool, self.stream = pool, stream
        self.path: Tuple[str, ...] = ()     # the ranges the code runs in now
        self.segments: List[Segment] = []
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.graph_path: Tuple[str, ...] = ()
        self.start: Tuple[int, ...] = ()

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.graph_path = self.path
        self.start = _launches()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def end(self) -> None:
        """End the open graph; keep it unless it captured nothing."""
        graph, self.graph = self.graph, None
        launched = tuple(a - b for a, b in zip(_launches(), self.start))
        if _build.captured_nodes(self.stream):
            graph.capture_end()
            self.segments.append(Segment(self.graph_path, graph, launched))
            return
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            graph.capture_end()

    def move(self, path: Tuple[str, ...]) -> None:
        """The code enters or leaves a range, and now runs in ``path``."""
        self.path = path
        if _build.captured_nodes(self.stream):
            self.end()
            self.begin()
        else:
            self.graph_path = path

    def abort(self) -> None:
        if self.graph is not None:
            graph, self.graph = self.graph, None
            with contextlib.suppress(RuntimeError), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                graph.capture_end()


class GraphSet:
    """A model's forward at one key as captured segments, with its own
    input and output buffers."""

    def __init__(self, key, model, x: torch.Tensor, stream: torch.cuda.Stream):
        """Capture ``model(x)``; ``x`` becomes the set's input buffer. The
        wrappers' counters are left as they were: nothing ran."""
        self.key, self.input, self.device = key, x, x.device
        before = _launches()
        cap = _Capture(torch.cuda.graph_pool_handle(), stream)
        stream.wait_stream(torch.cuda.current_stream(x.device))
        _local.capture = cap
        try:
            with torch.cuda.device(x.device), torch.cuda.stream(stream):
                cap.begin()
                out = model(x)
                cap.end()
        except BaseException:
            cap.abort()
            raise
        finally:
            _local.capture = None
            _set_launches(before)
        torch.cuda.current_stream(x.device).wait_stream(stream)
        self.output = out
        self.segments = cap.segments

    def replay(self) -> torch.Tensor:
        """Run every segment in order, each inside its range path; returns
        the output buffer."""
        ranges: list = []           # the open ranges, outermost first
        path: Tuple[str, ...] = ()
        try:
            with torch.cuda.device(self.device):
                for seg in self.segments:
                    keep = 0
                    while (keep < min(len(path), len(seg.path))
                           and path[keep] == seg.path[keep]):
                        keep += 1
                    while len(ranges) > keep:
                        ranges.pop().__exit__(None, None, None)
                    for name in seg.path[keep:]:
                        r = record_function(name)
                        r.__enter__()
                        ranges.append(r)
                    path = seg.path
                    seg.graph.replay()
                    for fn, n in zip(COUNTED, seg.launches):
                        fn.launches += n
        finally:
            while ranges:
                ranges.pop().__exit__(None, None, None)
        return self.output


class GraphedForward:
    """One model's graph state: the previous call's key and the live
    ``GraphSet``. Holds no reference to the model."""

    def __init__(self):
        self.last = None
        self.set: Optional[GraphSet] = None

    @staticmethod
    def key(model, lr: torch.Tensor, device: torch.device):
        """The call's key, or None where the forward is not captured: off
        CUDA, or with grad enabled and something it reads requiring it."""
        if device.type != "cuda":
            return None
        state = list(itertools.chain(model.parameters(), model.buffers()))
        if torch.is_grad_enabled() and (
                lr.requires_grad or any(p.requires_grad for p in state)):
            return None
        return (tuple(lr.shape), lr.dtype, device,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
                tuple((p._version, p.data_ptr()) for p in state))

    def upload(self, model, lr: torch.Tensor, device: torch.device
               ) -> Tuple[torch.Tensor, str]:
        """``lr`` on the model's device and how ``forward`` will run it:
        "replay" (copied into the live set's input), "capture" (a copy of
        its own, to become the new set's input), "warm" (the first call at
        a key that can be captured) or "eager"."""
        key = self.key(model, lr, device)
        if self.set is not None and key is not None and self.set.key == key:
            self.set.input.copy_(lr)
            return self.set.input, "replay"
        self.set = None         # frees the old set's graphs, pool and buffers
        repeat = key is not None and key == self.last
        self.last = key
        if key is None:
            return lr.to(device), "eager"
        return lr.to(device, copy=repeat), "capture" if repeat else "warm"

    def forward(self, model, x: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "eager":
            return model(x)
        stream = capture_stream(x.device)
        if mode == "warm":
            # on the stream the capture will use, so that the libraries'
            # per-stream workspaces are made outside the graphs' pool; each
            # stream waits for the other's work
            current = torch.cuda.current_stream(x.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                out = model(x)
            current.wait_stream(stream)
            return out
        if mode == "capture":
            self.set = GraphSet(self.last, model, x, stream)
        return self.set.replay()


_STATE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_STREAMS: dict = {}     # device -> the stream every capture on it runs on


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that captures, and the warm-ups before them, run on:
    one a device, so that its library workspaces are made once."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


def graphed(model) -> GraphedForward:
    """The model's graph state, made on first use and dropped with the
    model."""
    g = _STATE.get(model)
    if g is None:
        g = _STATE[model] = GraphedForward()
    return g


def release(model) -> None:
    """Free the model's captured graphs, if it has any; the next call at
    the same key runs eagerly again."""
    _STATE.pop(model, None)

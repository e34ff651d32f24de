"""The process-group mesh of the port, as the JAX package's
``runtime/mesh.py``: one process per rank, one device per process, and
the (data, time, space, model) axes as groups of ranks.

- "data":  data parallelism; the gradients are averaged over it.
- "time":  temporal context parallelism; contiguous frame blocks, with the
           boundary frames exchanged between neighbouring ranks.
- "space": H strips of the model's tail (``parallel/spatial.py``).
- "model": Megatron tensor parallelism of the SR trunk.

Ranks are laid out row-major over (data, time, space, model): data
outermost, model innermost, so the per-block all-reduce of the model axis
runs between neighbouring ranks.

The few collectives the parallel modes need are here and nowhere else: the
mean and the sum all-reduce over an axis, the all-gather along an axis, the
exchange with the neighbours along an axis, and the two autograd functions
of the Megatron block around them. Each goes through the process group's
backend: NCCL for CUDA tensors and gloo for CPU ones by default
(``"cpu:gloo,cuda:nccl"``), or the one backend the caller names. NCCL
refuses two ranks on one device, so a job with several ranks on one card
names gloo. gloo carries CUDA tensors for the all-reduce and the
all-gather (it copies them through host memory itself), but its send and
receive hand the device pointer to its TCP transport, which aborts the
process (``writev ... Bad address``); so for the neighbour exchange gloo
is handed host copies (``_GLOO_HOST_STAGED``): the transport, not a
fallback, since the compute stays on the device. ``chip_smoke.py``'s
gloo probe checks on the card that gloo carries exactly the collectives
not staged. ``Mesh.transport`` counts which backend and transport carried
each collective.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import itertools
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from video_super_resolution_tpu_torch.config import MeshConfig

AXIS_DATA = "data"
AXIS_TIME = "time"
AXIS_SPACE = "space"
AXIS_MODEL = "model"
AXES = (AXIS_DATA, AXIS_TIME, AXIS_SPACE, AXIS_MODEL)

# collectives handed host copies of CUDA tensors when the group's backend
# for them is gloo (its send/recv cannot read device memory)
_GLOO_HOST_STAGED = ("exchange",)


def default_device(device=None) -> torch.device:
    """``device``, or ``cuda:{LOCAL_RANK}``; a CUDA device without a GPU
    raises, as ``api.resolve_device``."""
    from video_super_resolution_tpu_torch.api import resolve_device

    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    return resolve_device(device)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on the mesh: its coordinates, one process group
    per axis (None on ``local_mesh``, which has no process group) and its
    device. ``transport`` counts (collective, backend, transport) of every
    collective issued through it."""

    cfg: MeshConfig
    device: torch.device
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    transport: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def shape(self) -> Dict[str, int]:
        return self.cfg.shape

    def size(self, axis: str) -> int:
        return self.cfg.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def ranks(self, axis: str) -> List[int]:
        """The world ranks along ``axis`` through this rank, in order."""
        return _axis_ranks(self.cfg, self.coords, axis)


def _rank_of(cfg: MeshConfig, coords: Dict[str, int]) -> int:
    r = 0
    for a in AXES:
        r = r * cfg.shape[a] + coords[a]
    return r


def _coords_of(cfg: MeshConfig, rank: int) -> Dict[str, int]:
    coords = {}
    for a in reversed(AXES):
        rank, coords[a] = divmod(rank, cfg.shape[a])
    return coords


def _axis_ranks(cfg: MeshConfig, coords: Dict[str, int], axis: str) -> List[int]:
    return [_rank_of(cfg, {**coords, axis: i}) for i in range(cfg.shape[axis])]


def build_mesh(cfg: MeshConfig, device=None) -> Mesh:
    """The mesh of ``cfg`` over the initialized process group, one rank a
    device (``device``, default ``cuda:{LOCAL_RANK}``). A one-device
    ``cfg`` without a process group is ``local_mesh``. Raises ValueError
    when ``cfg`` needs more than one device and no process group is
    initialized, or when its device count differs from the world size.

    Every rank must call it, in the same order as its other group
    creations: ``new_group`` is collective."""
    dev = default_device(device)
    if not dist.is_initialized():
        if cfg.num_devices == 1:
            return local_mesh(dev)
        raise ValueError(
            f"mesh {cfg.shape} needs {cfg.num_devices} processes in an "
            "initialized torch.distributed process group: call "
            "runtime.mesh.initialize_distributed or launch under torchrun")
    world = dist.get_world_size()
    if cfg.num_devices != world:
        raise ValueError(f"mesh {cfg.shape} needs {cfg.num_devices} devices, "
                         f"the process group has {world}")
    coords = _coords_of(cfg, dist.get_rank())
    groups = {}
    for axis in AXES:
        others = [a for a in AXES if a != axis]
        for fixed in itertools.product(*(range(cfg.shape[a]) for a in others)):
            ranks = _axis_ranks(cfg, {**dict(zip(others, fixed)), axis: 0},
                                axis)
            group = dist.new_group(ranks)
            if all(coords[a] == v for a, v in zip(others, fixed)):
                groups[axis] = group
    return Mesh(cfg, dev, coords, groups)


def local_mesh(device=None) -> Mesh:
    """The one-rank mesh: no process group, every collective the
    identity."""
    return Mesh(MeshConfig(), default_device(device),
                {a: 0 for a in AXES}, {a: None for a in AXES})


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None, backend: Optional[str] = None
                           ) -> None:
    """Join the job's process group: ``init_process_group`` at
    ``tcp://{coordinator}`` ("host:port") with ``num_processes`` ranks as
    rank ``process_id`` (default: the ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` that torchrun sets), then a barrier: one
    all-reduce on the rank's device, so that every rank has joined before
    any work starts. The timeout of the rendezvous and of every collective
    is ``VSR_COORD_BARRIER_TIMEOUT_S`` seconds (default 600), as the JAX
    package's coordination barrier.

    backend: default ``"cpu:gloo,cuda:nccl"`` for a CUDA ``device`` (NCCL
    needs one GPU a rank) and ``"gloo"`` for the CPU."""
    dev = default_device(device)
    if coordinator is None:
        coordinator = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                       f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = int(os.environ.get("VSR_COORD_BARRIER_TIMEOUT_S", "600"))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    dist.all_reduce(torch.zeros(1, device=dev))


# ------------------------------------------------------------ collectives

def _route(mesh: Mesh, axis: str, op: str, t: torch.Tensor
           ) -> Tuple[Optional[dist.ProcessGroup], bool]:
    """(group, stage through host memory) for collective ``op`` of ``t``
    along ``axis``; counts the route in ``mesh.transport``. An axis of one
    rank has no group to go through: every collective along it is the
    identity (a gloo all-gather would copy the tensor through host memory
    and back)."""
    group = mesh.groups[axis]
    if group is None or mesh.size(axis) == 1:
        return None, False
    backend = dist.get_backend(group)
    if t.is_cuda:
        name = "nccl" if "nccl" in backend else "gloo"
    else:
        name = "gloo" if "gloo" in backend else backend
    staged = (t.is_cuda and name == "gloo" and op in _GLOO_HOST_STAGED)
    where = "host-staged" if staged else ("device" if t.is_cuda else "host")
    mesh.transport[(op, name, where)] += 1
    return group, staged


def all_reduce_sum_(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """In place: ``t`` summed over ``axis``."""
    group, _ = _route(mesh, axis, "all_reduce", t)
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean_(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """In place: ``t`` averaged over ``axis``."""
    all_reduce_sum_(t, mesh, axis)
    return t.div_(mesh.size(axis))


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """``t`` of every rank along ``axis``, in the axis' order (same shape on
    every rank), on ``t``'s device."""
    group, staged = _route(mesh, axis, "all_gather", t)
    if group is None:
        return [t]
    src = t.contiguous().cpu() if staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if staged else out


def exchange_neighbors(to_left: torch.Tensor, to_right: torch.Tensor,
                       mesh: Mesh, axis: str
                       ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Send ``to_left`` to the previous rank along ``axis`` and
    ``to_right`` to the next one; return (what the previous rank sent
    right, what the next rank sent left), None at the ends (no
    wraparound). Point-to-point sends and receives, all posted at once."""
    n, i = mesh.size(axis), mesh.index(axis)
    if n == 1:
        return None, None
    group, staged = _route(mesh, axis, "exchange", to_left)
    ranks = mesh.ranks(axis)
    dev = to_left.device
    to_left, to_right = (x.contiguous().cpu() if staged else x.contiguous()
                         for x in (to_left, to_right))
    ops, from_left, from_right = [], None, None
    if i > 0:
        from_left = torch.empty_like(to_right)
        ops += [dist.P2POp(dist.isend, to_left, ranks[i - 1], group),
                dist.P2POp(dist.irecv, from_left, ranks[i - 1], group)]
    if i < n - 1:
        from_right = torch.empty_like(to_left)
        ops += [dist.P2POp(dist.isend, to_right, ranks[i + 1], group),
                dist.P2POp(dist.irecv, from_right, ranks[i + 1], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(None if x is None else x.to(dev)
                 for x in (from_left, from_right))


class _CopyToModelGroup(torch.autograd.Function):
    """Megatron's f: the identity forward; the backward sums the input's
    gradient over the model axis (each rank's trunk slice contributes a
    part of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous().clone(), ctx.mesh, AXIS_MODEL), None


class _ReduceFromModelGroup(torch.autograd.Function):
    """Megatron's g: the forward sums the partial outputs over the model
    axis; the backward is the identity (what follows is replicated)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum_(x.contiguous().clone(), mesh, AXIS_MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model_group(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModelGroup.apply(x, mesh)


def reduce_from_model_group(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModelGroup.apply(x, mesh)

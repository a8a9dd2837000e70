"""The device mesh over ``torch.distributed`` (port of `gpscore/parallel/mesh.py`).

JAX lays its devices out as a 2-D ('batch', 'data') mesh and lets GSPMD and
``shard_map`` place the collectives. torch has neither: here every rank is
one process with one device, the mesh is a ``DeviceMesh`` that cuts the
default process group into the same 2-D layout, and every collective of the
sharded modules is written out over one of the mesh's two sub-groups:

- ``batch``: independent work (restarts, replicates); the ranks that share a
  'data' coordinate split it, with no collective but the final gather;
- ``data``: training-set rows; the ranks that share a 'batch' coordinate
  each hold a block of n/p rows of every row-sharded operand.

Rank r sits at ('batch', 'data') = divmod(r, data), as JAX's
``devices.reshape(batch, data)`` places device r. The backend follows the
device the caller names: NCCL for a CUDA device, gloo for the CPU
(:func:`init_distributed`); nothing picks gloo for a card.

Calling conventions of the sharded modules: a row-sharded operand is passed
and returned as this rank's row block ([n/p, ...]); where the JAX function
returns a replicated value, every rank returns the same full value.
:func:`shard_rows` and :func:`gather_rows` move between the two forms.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

# The build directory at the repository root, beside the kernels' build.
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# torch 2.13 deprecates all_gather_into_tensor and reduce_scatter_tensor for
# all_gather_single and reduce_scatter_single (the same arguments), which
# older releases lack.
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)

# The collectives this process issued through the helpers below, by kind:
# how many, and the bytes of their output on this rank (what a rank receives
# or holds after the call: the gathered array, the scattered block, the
# broadcast or reduced tensor). reset_collectives() sets them to 0.
COLLECTIVES = {kind: {"count": 0, "bytes": 0}
               for kind in ("broadcast", "all_gather", "all_reduce", "reduce_scatter", "reduce")}


def reset_collectives() -> None:
    for c in COLLECTIVES.values():
        c.update(count=0, bytes=0)


def _issued(kind: str, out) -> None:
    COLLECTIVES[kind]["count"] += 1
    COLLECTIVES[kind]["bytes"] += out.numel() * out.element_size()


def init_distributed(device=None, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None) -> torch.device:
    """Join the default process group, unless this process already has, and
    return this rank's device.

    ``device``: "cuda" (this rank's card, ``LOCAL_RANK`` under ``torchrun``,
    made current with ``torch.cuda.set_device``; backend NCCL) or "cpu"
    (backend gloo); a CUDA device with an index keeps it. ``init_method``,
    ``world_size`` and ``rank``: as ``dist.init_process_group`` takes them
    (default: ``env://``, the variables ``torchrun`` sets; a single process
    with none of them set joins a group of one through a ``file://`` store
    in the repository's ``build/``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is None and "RANK" not in os.environ:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = _BUILD_DIR / f"dist_store_{os.getpid()}"
        path.unlink(missing_ok=True)
        init_method, world_size, rank = f"file://{path}", 1, 0
    kw = {} if init_method is None else {"init_method": init_method}
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    dist.init_process_group(backend, **kw)
    return device


class Mesh:
    """The ('batch', 'data') mesh of ``batch * data`` ranks over the default
    group, a ``torch.distributed`` ``DeviceMesh`` under JAX's names: this
    rank's coordinates, the sizes of the two axes, and the two sub-groups
    this rank belongs to (``group("data")``: the ranks that split the rows
    with it; ``group("batch")``: those that split the restarts)."""

    def __init__(self, batch: int, data: int, device):
        world = dist.get_world_size()
        if batch * data != world:
            raise ValueError(f"batch*data = {batch}*{data} != {world} devices")
        self.shape = {"batch": batch, "data": data}
        self.device = torch.device(device)  # this rank's: where place() puts data
        self._mesh = init_device_mesh(self.device.type, (batch, data),
                                      mesh_dim_names=("batch", "data"))
        self.coords = dict(zip(self.shape, self._mesh.get_coordinate()))
        self._ranks = {a: dist.get_process_group_ranks(self.group(a)) for a in self.shape}

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str):
        return self._mesh.get_group(axis)

    def global_rank(self, axis: str, i: int) -> int:
        """The global rank at coordinate ``i`` of ``axis`` beside this rank:
        ``dist.broadcast``'s ``src`` is global even inside a sub-group."""
        return self._ranks[axis][i]


def make_mesh(devices=None, batch: Optional[int] = None, data: int = 1) -> Mesh:
    """2-D ('batch', 'data') mesh over the default group; by default every
    rank on the batch axis. ``devices``: this rank's device (default: the
    current card under NCCL, the CPU under gloo). The process group must
    exist (:func:`init_distributed`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    n = dist.get_world_size()
    if batch is None:
        batch = n // data
    if devices is None:
        nccl = dist.get_backend() == "nccl"
        devices = torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu"
    return Mesh(batch, data, devices)


class Placement(NamedTuple):
    """Where an array lives on the mesh: its leading axis split over
    ``axis``, or (``axis`` None) whole on every rank."""

    mesh: Mesh
    axis: Optional[str]


def batch_sharding(mesh: Mesh) -> Placement:
    """Leading axis split over 'batch', everything else replicated."""
    return Placement(mesh, "batch")


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def _rows(n: int, mesh: Mesh, axis: str) -> int:
    p = mesh.size(axis)
    if n % p != 0:
        raise ValueError(f"{n} rows do not split over the {p} ranks of {axis!r}")
    return n // p


def shard_rows(t, mesh: Mesh, axis: str = "data"):
    """This rank's block of the leading axis of the full ``t``: rows
    [i n/p, (i + 1) n/p) at coordinate i of ``axis`` (a view)."""
    r = _rows(t.shape[0], mesh, axis)
    i = mesh.index(axis)
    return t[i * r:(i + 1) * r]


def gather_rows(t, mesh: Mesh, axis: str = "data"):
    """The full array of the row blocks ``t`` that the ranks of ``axis``
    hold, in coordinate order: one all-gather, the same result on every rank."""
    t = t.contiguous()
    p = mesh.size(axis)
    out = t.new_empty((p * t.shape[0], *t.shape[1:]))
    _all_gather(out, t, group=mesh.group(axis))
    _issued("all_gather", out)
    return out


def all_reduce_sum(t, mesh: Mesh, axis: str = "data"):
    """``t`` summed over the ranks of ``axis``, in place; every rank gets the sum."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    _issued("all_reduce", t)
    return t


def reduce_scatter_sum(t, mesh: Mesh, axis: str = "data"):
    """This rank's block of the leading axis of ``t`` [p r, ...] summed over
    the ranks of ``axis``: block i (rows [i r, (i + 1) r)) lands on
    coordinate i. One reduce-scatter; ``t`` must be contiguous."""
    assert t.is_contiguous()
    p = mesh.size(axis)
    out = t.new_empty((t.shape[0] // p, *t.shape[1:]))
    _reduce_scatter(out, t, group=mesh.group(axis))
    _issued("reduce_scatter", out)
    return out


def broadcast(t, owner: int, mesh: Mesh, axis: str = "data"):
    """``t`` (contiguous: a strided block was sent garbled at p > 1) from
    coordinate ``owner`` of ``axis`` to every rank of it, in place."""
    assert t.is_contiguous()
    dist.broadcast(t, src=mesh.global_rank(axis, owner), group=mesh.group(axis))
    _issued("broadcast", t)
    return t


def reduce_sum(t, owner: int, mesh: Mesh, axis: str = "data"):
    """``t`` summed over the ranks of ``axis`` onto coordinate ``owner``, in
    place there (the other ranks' ``t`` is left undefined)."""
    dist.reduce(t, dst=mesh.global_rank(axis, owner), group=mesh.group(axis))
    _issued("reduce", t)
    return t


def place(t, placement: Placement):
    """``t`` (full, the same on every rank) as ``placement`` holds it, on the
    mesh's device (``jax.device_put`` with a sharding): this rank's row
    block, or all of ``t`` when replicated."""
    t = t.to(placement.mesh.device)
    return t if placement.axis is None else shard_rows(t, placement.mesh, placement.axis)

"""Meshes of the port: one process per shard (counterpart of
:mod:`repro.distributed.sharding`: its data half, the meshes and
collectives, and its model half, the logical-axis rules and specs, at the
end of this module).

The reference's mesh is one controller over a global array: device ``i``
holds rows ``[i·n_loc, (i+1)·n_loc)`` of the input padded with EMPTY to
``world·n_loc`` rows, and ``shard_map`` runs one program over every shard.
The port is SPMD instead: every rank is a process that runs the same call
on its own rows, and the reference's ``all_gather`` / ``all_to_all`` /
``psum`` / ``pmax`` become ``torch.distributed`` collectives over the
mesh's process group.

* :func:`init_distributed` joins the ranks (``REPRO_COORDINATOR`` /
  ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` as the reference reads
  them, or torch's own ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
  ``MASTER_PORT``).  The collective backend is an explicit argument:
  ``"gloo"`` for CPU ranks and for several ranks sharing one card,
  ``"nccl"`` for one rank a card.  NCCL refuses two ranks on one card, so
  ``"nccl"`` with more ranks than cards raises.
* :class:`Mesh` / :func:`data_mesh` hold the process group (or a
  sub-group of it), ``world``, ``rank``, the axis name and the rank's
  device.  A mesh of one rank needs no process group: its collectives
  are copies.
* :func:`local_slice` gives rank ``r`` exactly the rows the reference's
  ``P(axis)`` sharding gives device ``r``, EMPTY/zero padding included,
  so that both packages can be fed the same shards.
* :func:`make_mesh` / :class:`NamedMesh` are the model paths' meshes of
  named axes (``("data", "model")``, ``("pod", "data", "model")``), with a
  1-D sub-mesh (and its process group) for every product of axes.
* :func:`psum`, :func:`pmean`, :func:`all_gather_tiled`,
  :func:`all_to_all_blocks` and :func:`ppermute` are collectives with a
  gradient, and :func:`replicated_input` / :func:`replicated_output` the
  boundary of per-rank work, in the reference's ``shard_map`` gradient
  convention (set out above them below).
* The model half: ``DEFAULT_RULES``, :func:`rules_for_mesh`,
  :func:`spec_from_axes`, :func:`tree_specs`, :func:`batch_spec`,
  :func:`cache_specs` and :func:`opt_state_specs` as the reference's (a
  spec is a tuple, as its ``PartitionSpec`` holds them), on a mesh of
  ranks or an :class:`AbstractMesh`; :func:`shard_of` (this rank's block of
  a global tensor, GSPMD's layout: the counterpart of ``shardings_for``
  and ``device_put``) and its inverse :func:`gather_full` (the counterpart
  of ``host_local_array``'s global array).

Gloo takes CUDA tensors for the three collectives used here and stages
them through host memory itself (probed on an H100 with torch 2.11.0 and
CUDA 12.8: ``all_to_all_single``, ``all_gather`` and ``all_reduce``;
``ppermute`` is an ``all_to_all_single`` too), so
ranks that share a card pass their device tensors as they are.  A gloo
collective on CUDA tensors synchronises the card's stream: a wait that
``types.SYNCS`` does not count.  A collective that fails raises; nothing
carries on without it.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.types import SYNCS

BACKENDS = ("gloo", "nccl")

# collectives this process took part in: on card tensors (each one, on
# gloo, also waits for the card's stream: a sync ``SYNCS`` does not see),
# on host tensors, and by kind (the ``torch.distributed`` call made; a
# ``ppermute`` is an ``all_to_all_single`` with one nonzero split each way)
KINDS = ("all_gather", "all_to_all", "all_reduce", "ppermute")
# ``<kind>_bytes``: the bytes of each call's result on this rank, with the
# reference roofline's wire factors (an all-reduce counts twice: a ring's
# reduce-scatter and all-gather phases)
COLLECTIVES = {"card": 0, "host": 0, **{k: 0 for k in KINDS},
               **{f"{k}_bytes": 0 for k in KINDS}}
_WIRE_FACTOR = {"all_gather": 1, "all_to_all": 1, "all_reduce": 2, "ppermute": 1}


def _count(t: torch.Tensor, kind: str, world: int = 1) -> None:
    COLLECTIVES["card" if t.is_cuda else "host"] += 1
    COLLECTIVES[kind] += 1
    n = t.numel() * t.element_size() * (world if kind == "all_gather" else 1)
    COLLECTIVES[f"{kind}_bytes"] += n * _WIRE_FACTOR[kind]


def _env_int(*names: str) -> int | None:
    for name in names:
        v = os.environ.get(name)
        if v:
            return int(v)
    return None


def init_distributed(*, backend: str, coordinator_address: str | None = None,
                     num_processes: int | None = None, process_id: int | None = None,
                     init_method: str | None = None, timeout_s: float | None = None) -> bool:
    """Join this process to the ranks of a mesh.

    The arguments default from the reference's environment
    (``REPRO_COORDINATOR=host:port``, ``REPRO_NUM_PROCESSES``,
    ``REPRO_PROCESS_ID``) or from torch's (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  ``init_method`` overrides the rendezvous
    (``file:///path`` for ranks of one machine, as the tests use).
    ``backend`` is ``"gloo"`` or ``"nccl"``, chosen by the caller; with
    ``"nccl"`` each rank takes the card ``LOCAL_RANK`` (default: its rank)
    and more ranks on this host than cards raise.

    One process (no world configured, or a world of 1) is a no-op that
    returns False; a second call after a successful one returns True
    without joining again.  ``timeout_s`` bounds how long a collective
    waits for the other ranks before it raises (torch's default else)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown collective backend {backend!r}; expected one of {BACKENDS}")
    world = num_processes if num_processes is not None else _env_int(
        "REPRO_NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("REPRO_PROCESS_ID", "RANK")
    if not world or world == 1:
        return False
    if dist.is_initialized():
        return True
    if rank is None:
        raise ValueError("init_distributed: a world of several ranks needs this process's "
                         "rank (process_id=, REPRO_PROCESS_ID or RANK)")
    if init_method is None:
        addr = coordinator_address or os.environ.get("REPRO_COORDINATOR")
        if addr is None and os.environ.get("MASTER_ADDR"):
            addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        if addr is None:
            raise ValueError("init_distributed: no rendezvous (coordinator_address=, "
                             "REPRO_COORDINATOR, MASTER_ADDR/MASTER_PORT or init_method=)")
        init_method = f"tcp://{addr}"
    if backend == "nccl":
        cards = torch.cuda.device_count()
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
        if local_world > cards:
            raise RuntimeError(
                f"backend='nccl' with {local_world} ranks on a host with {cards} CUDA "
                "card(s): NCCL refuses two ranks on one card; use backend='gloo' to share "
                "a card")
        torch.cuda.set_device(local_rank)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kw)
    return True


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of ranks: the process ``group`` (None for a mesh of one
    rank, whose collectives are copies), ``world`` and this process's
    ``rank`` in it, the ``axis`` name, this rank's ``device`` and the
    collective ``backend``."""

    axis: str
    world: int
    rank: int
    device: torch.device
    group: Any = None
    backend: str = "none"

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis,)


def _rank_device(device, backend: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available here; pass device='cpu' for a mesh of "
                               "CPU ranks")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif backend == "nccl":
        raise ValueError(f"backend='nccl' needs CUDA ranks, got device {dev}")
    return dev


def data_mesh(axis: str = "shard", *, device="cuda", ranks=None) -> Mesh | None:
    """A mesh over every rank :func:`init_distributed` joined (one rank,
    without a process group, when it joined none).  ``ranks`` takes a
    sub-group of them (every rank of the world must make the call, as
    ``torch.distributed.new_group`` demands; a rank outside ``ranks`` gets
    None), so that a pool of 4 ranks can run a world of 2 without another
    spawn.  ``device`` is this rank's device (the entry points' ``device``
    must be of its type)."""
    if not dist.is_initialized():
        if ranks is not None and list(ranks) != [0]:
            raise ValueError(f"ranks={list(ranks)} without init_distributed: only [0]")
        return Mesh(axis=axis, world=1, rank=0, device=_rank_device(device, "none"))
    backend = str(dist.get_backend())
    group = None
    if ranks is not None:
        ranks = sorted(int(r) for r in ranks)
        group = dist.new_group(ranks)
        if dist.get_rank() not in ranks:
            return None
        world, rank = len(ranks), ranks.index(dist.get_rank())
    else:
        world, rank = dist.get_world_size(), dist.get_rank()
    return Mesh(axis=axis, world=world, rank=rank, device=_rank_device(device, backend),
                group=group, backend=backend)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedMesh:
    """A mesh of ranks with named axes (counterpart of a ``jax.make_mesh``
    mesh): ``axis_names``, ``shape`` (axis -> size, in axis order, as a JAX
    mesh's ``shape``), this rank's ``coords`` (axis -> coordinate), its
    ``rank`` among the mesh's ``world`` ranks (row-major over the axes), its
    ``device`` and the collective ``backend``.  :meth:`sub` gives the 1-D
    :class:`Mesh` of one axis or of a product of axes: the ranks that share
    this rank's coordinates on every other axis, in row-major order over
    the named ones (JAX's ``axis_index`` of that tuple of axes)."""

    axis_names: tuple
    shape: dict
    coords: dict
    rank: int
    world: int
    device: torch.device
    backend: str
    subs: dict  # tuple of axes (in mesh order) -> Mesh

    def sub(self, axes) -> Mesh:
        """The 1-D sub-mesh of ``axes`` (an axis name or a tuple of them in
        the mesh's order; ``()`` is this rank alone)."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if key not in self.subs:
            raise ValueError(f"no sub-mesh {key}: axes are {self.axis_names}, taken in that "
                             "order")
        return self.subs[key]


_GROUPS: dict = {}  # member ranks -> the process group make_mesh made for them


def make_mesh(shape, axes, *, device="cuda", ranks=None) -> NamedMesh | None:
    """A mesh of named axes over the ranks :func:`init_distributed` joined
    (counterpart of ``jax.make_mesh`` and of the reference's
    ``launch.mesh.make_test_mesh``): rank ``ranks[i]`` (default: every
    rank, in order) sits at the row-major coordinates of ``i`` in
    ``shape``.  Every sub-mesh of a product of axes gets its process groups
    here, made by ``torch.distributed.new_group`` on every rank of the world
    in one order (as it demands; a rank outside ``ranks`` makes them too,
    and gets None), one group for each set of members however many meshes
    ask for it.  A sub-mesh of one rank needs no group, nor does a
    mesh of one rank without ``init_distributed``; the sub-mesh of every
    axis over the whole world is the default group."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    size = math.prod(shape)
    if dist.is_initialized():
        everyone = list(range(dist.get_world_size()))
        members = everyone if ranks is None else sorted(int(r) for r in ranks)
        me, backend = dist.get_rank(), str(dist.get_backend())
    else:
        members = everyone = [0]
        me, backend = 0, "none"
    if len(members) != size or not set(members) <= set(everyone):
        raise ValueError(f"a mesh of shape {shape} needs {size} ranks, got {members} of "
                         f"{len(everyone)}")
    inside = me in members
    coords = np.unravel_index(members.index(me), shape) if inside else None
    dev = _rank_device(device, backend) if inside else None
    subs = {}

    def group_of(grp: list):
        key = tuple(grp)
        if key not in _GROUPS:  # one group per member set: every rank asks in one order
            _GROUPS[key] = dist.new_group(grp)
        return _GROUPS[key]

    for n_axes in range(len(axes) + 1):
        for named in itertools.combinations(range(len(axes)), n_axes):
            others = [i for i in range(len(axes)) if i not in named]
            sub_shape = tuple(shape[i] for i in named)
            sub_world = math.prod(sub_shape)
            group = None
            if sub_world > 1 and not (sub_world == size and members == everyone):
                for fixed in itertools.product(*(range(shape[i]) for i in others)):
                    at = np.zeros(len(axes), np.int64)
                    at[others] = fixed
                    grp = []
                    for inner in itertools.product(*(range(n) for n in sub_shape)):
                        at[list(named)] = inner
                        grp.append(members[int(np.ravel_multi_index(at, shape))])
                    g = group_of(grp)
                    if inside and all(coords[i] == v for i, v in zip(others, fixed)):
                        group = g
            if inside:
                sub_rank = (int(np.ravel_multi_index([coords[i] for i in named], sub_shape))
                            if named else 0)
                key = tuple(axes[i] for i in named)
                subs[key] = Mesh(axis="+".join(key), world=sub_world, rank=sub_rank,
                                 device=dev, group=group, backend=backend)
    if not inside:
        return None
    return NamedMesh(axis_names=axes, shape=dict(zip(axes, shape)),
                     coords={a: int(c) for a, c in zip(axes, coords)},
                     rank=members.index(me), world=size, device=dev, backend=backend,
                     subs=subs)


def resolve_mesh_axis(mesh: Mesh, mesh_axis: str | None) -> str:
    """The mesh axis the pipeline shards over (default: the mesh's)."""
    if mesh_axis is None:
        return mesh.axis_names[0]
    if mesh_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {mesh_axis!r}; axes: {mesh.axis_names}")
    return mesh_axis


def check_mesh_device(mesh: Mesh, device) -> None:
    """An entry point's device must be of the mesh's device type."""
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device} on a mesh of {mesh.device.type} ranks")


def local_slice(x, mesh: Mesh, *, pad: bool = True) -> np.ndarray:
    """This rank's rows of the host array ``x`` (its leading axis), as the
    reference's ``P(axis)`` sharding places them on device ``mesh.rank``:
    ``n_loc = ceil(n/world)`` rows from ``rank·n_loc``.  With ``pad`` the
    slice is padded to ``n_loc`` rows as the reference pads the global
    input: EMPTY (the dtype's all-ones) for unsigned keys, zero otherwise.
    An ``np.memmap`` is read only where the slice lies."""
    n = len(x)
    n_loc = -(-n // mesh.world)
    start = min(mesh.rank * n_loc, n)
    part = np.array(x[start:start + n_loc])  # a copy: a slice of an mmap stays read-only
    short = n_loc - part.shape[0]
    if not pad or short == 0:
        return part
    fill = np.iinfo(part.dtype).max if part.dtype.kind == "u" else 0
    return np.concatenate([part, np.full((short,) + part.shape[1:], fill, part.dtype)])


# ---------------------------------------------------------------------------
# collectives (a mesh of one rank copies)
# ---------------------------------------------------------------------------


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: ``(world,) + t.shape``."""
    if mesh.world == 1:
        return t[None].clone()
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    _count(src, "all_gather", mesh.world)
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts)


def all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Equal splits of ``t``'s leading axis: split ``i`` goes to rank ``i``,
    and split ``i`` of the result came from rank ``i``."""
    if mesh.world == 1:
        return t.clone()
    src = t.contiguous()
    out = torch.empty_like(src)
    _count(src, "all_to_all")
    dist.all_to_all_single(out, src, group=mesh.group)
    return out


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced over the ranks, ``op`` ``"sum"`` or ``"max"`` (a new
    tensor)."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if mesh.world == 1:
        return t.clone()
    buf = t.clone()
    _count(buf, "all_reduce")
    dist.all_reduce(buf, op=red, group=mesh.group)
    return buf


def host_all_reduce(mesh: Mesh, values, op: str) -> list[int]:
    """Host ints reduced over the ranks.  On gloo they travel as a CPU
    tensor and the card is not involved; NCCL needs them on the card, and
    their readback is counted in ``SYNCS``."""
    if mesh.world == 1:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
        SYNCS["host_syncs"] += 1
    return all_reduce(mesh, t, op).tolist()


def barrier(mesh: Mesh) -> None:
    if mesh.world > 1:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


def ppermute_start(mesh: Mesh, t: torch.Tensor, shift: int = 1):
    """Start sending ``t`` to rank ``(r + shift) mod world`` and receiving
    the tensor of the same shape that rank ``(r - shift) mod world`` sends:
    returns ``(out, work)``, and ``out`` holds the received tensor once
    ``work.wait()`` returned (None for a mesh of one rank, whose ``out`` is
    a copy).  One ``all_to_all_single`` with a single nonzero split each
    way, a collective gloo takes on card tensors as it takes the equal
    splits (it stages them through host memory itself)."""
    if mesh.world == 1 or shift % mesh.world == 0:
        return t.clone(), None
    src = t.contiguous().reshape(-1)
    out = torch.empty_like(src)
    send, recv = [0] * mesh.world, [0] * mesh.world
    send[(mesh.rank + shift) % mesh.world] = src.numel()
    recv[(mesh.rank - shift) % mesh.world] = src.numel()
    _count(src, "ppermute")
    work = dist.all_to_all_single(out, src, output_split_sizes=recv, input_split_sizes=send,
                                  group=mesh.group, async_op=True)
    return out.view(t.shape), work


# ---------------------------------------------------------------------------
# differentiable collectives (the reference's shard_map gradients)
# ---------------------------------------------------------------------------
#
# The gradient convention is the reference's: ``shard_map`` with its
# replication check off, as its mesh paths are written.  The loss is one
# function of every rank's outputs, each value counted once however many
# ranks hold a copy of it.  So
#
# * an output replicated over a sub-mesh of n ranks gives each copy 1/n of
#   its cotangent (:func:`replicated_output`);
# * an input replicated over a sub-mesh receives the sum of its copies'
#   cotangents (:func:`replicated_input`, JAX's ``pvary``);
# * in between, each collective's backward is its transpose: ``psum``'s is
#   ``psum``, the tiled all-gather's is a reduce-scatter (an all-reduce,
#   then this rank's slice: gloo has no reduce-scatter), the all-to-all's
#   the same all-to-all, and ``ppermute``'s the reverse ``ppermute``.
#
# Every rank must call ``backward`` on its loss, as every rank ran the
# forward: the backward's collectives are collectives too.


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g, "sum"), None


class _ReplicatedOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.world = mesh.world
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.world, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce(mesh, t, "sum")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(ctx.mesh, g, "sum"), None


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim, ctx.n = mesh, dim, t.shape[dim]
        return torch.cat(list(all_gather(mesh, t)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        full = all_reduce(ctx.mesh, g, "sum")
        return full.narrow(ctx.dim, ctx.mesh.rank * ctx.n, ctx.n).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_to_all(mesh, t)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(ctx.mesh, g), None


def _ppermute_done(mesh: Mesh, t: torch.Tensor, shift: int) -> torch.Tensor:
    out, work = ppermute_start(mesh, t, shift)
    if work is not None:
        work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, shift):
        ctx.mesh, ctx.shift = mesh, shift
        return _ppermute_done(mesh, t, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute_done(ctx.mesh, g, -ctx.shift), None, None


def replicated_input(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t``, which every rank of ``mesh`` holds alike, entering per-rank
    work: the identity; its gradient is the sum over the ranks of theirs
    (JAX's ``pvary``; ``shard_map``'s ``psum`` of an unsharded input's
    cotangent)."""
    return _ReplicatedInput.apply(t, mesh)


def replicated_output(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t``, equal on every rank of ``mesh``, leaving as one value: the
    identity; each rank's copy takes 1/world of the cotangent
    (``shard_map``'s division of an unsharded output's cotangent)."""
    return _ReplicatedOutput.apply(t, mesh)


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks; the backward sums the cotangents."""
    return _PSum.apply(t, mesh)


def pmean(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` averaged over the ranks (``psum / world``)."""
    return psum(mesh, t) / mesh.world


def all_gather_tiled(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(tiled=True)``); the backward is a reduce-scatter: the
    cotangents summed over the ranks, and this rank's slice of them."""
    return _AllGatherTiled.apply(t, mesh, dim)


def all_to_all_blocks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Block ``i`` of ``t``'s leading axis (``world`` equal blocks) goes to
    rank ``i``; block ``i`` of the result came from rank ``i`` (JAX's
    ``all_to_all`` with split and concat axis 0).  Its own transpose: the
    backward sends the cotangents' blocks back the same way."""
    return _AllToAll.apply(t, mesh)


def ppermute(mesh: Mesh, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``t`` sent to rank ``(r + shift) mod world`` around the ring (JAX's
    ``ppermute`` with that permutation); the backward sends the cotangent
    back, ``-shift``."""
    return _PPermute.apply(t, mesh, shift)


# ---------------------------------------------------------------------------
# the model half: logical-axis rules, specs, and a tensor's shard
# ---------------------------------------------------------------------------
#
# A model's parameters carry logical axis names ("embed", "heads", "vocab",
# "expert", ...; ``repro_torch.models.model.logical_axes``).  Rules map them
# to mesh axes, and a spec is what the reference's ``PartitionSpec`` holds: a
# tuple with one entry per dimension, each None (replicated), a mesh axis
# name, or a tuple of names (split over their product, the first the
# slowest).  A conflict pass keeps a mesh axis at most once a spec: the
# first logical axis wins, later ones fall back to replication, and a tuple
# rule keeps only its axes still free.  The default recipe, the reference's:
#
#   vocab / heads / kv_heads / mlp / expert / inner -> "model"   (TP/EP)
#   embed                                           -> "data"    (FSDP)
#   layers / lora / unnamed                         -> replicated
#
# with the batch of activations and inputs split over ("pod", "data").  A
# dimension that does not divide its axes' ranks is split as GSPMD splits
# it: blocks of ceil(n / ranks), the last ones padded with zeros (an
# all-pad block is possible), so bytes at rest count the pad.

DEFAULT_RULES: dict[str, Any] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "inner": "model",
    "embed": "data",  # FSDP / ZeRO-3
    "lora": None,
    "layers": None,
}
DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axes and sizes without ranks (the counterpart of JAX's
    ``AbstractMesh``): what the spec functions read, for meshes larger than
    the world at hand (the production meshes' 256 and 512 ranks)."""

    axis_names: tuple
    shape: dict

    @classmethod
    def of(cls, shape, axes) -> "AbstractMesh":
        return cls(tuple(axes), dict(zip(axes, (int(n) for n in shape))))


def rules_for_mesh(mesh) -> dict[str, Any]:
    """The default rules; with a ``"pod"`` axis FSDP spans both data axes
    (``embed`` -> ``("pod", "data")``), so parameter shards halve when pods
    double."""
    rules = dict(DEFAULT_RULES)
    if "pod" in mesh.axis_names:
        rules["embed"] = ("pod", "data")
    return rules


def spec_from_axes(axes, rules=None) -> tuple:
    """A tuple of logical names (None for an unnamed dimension) -> a spec,
    with the conflict pass (module comment above)."""
    rules = rules or DEFAULT_RULES
    used: set[str] = set()
    out = []
    for ax in axes:
        mesh_ax = rules.get(ax) if ax is not None else None
        if isinstance(mesh_ax, tuple):
            free = tuple(a for a in mesh_ax if a not in used)
            if not free:
                out.append(None)
                continue
            out.append(free if len(free) > 1 else free[0])
            used.update(free)
        elif mesh_ax is None or mesh_ax in used:
            out.append(None)
        else:
            out.append(mesh_ax)
            used.add(mesh_ax)
    return tuple(out)


def tree_specs(spec_tree, rules=None):
    """A tree (dicts, lists, tuples of trees) whose leaves are tuples of
    logical names -> the same tree of specs."""
    if isinstance(spec_tree, dict):
        return {k: tree_specs(v, rules) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [tree_specs(v, rules) for v in spec_tree]
    return spec_from_axes(spec_tree, rules)


def map_specs(fn, tree):
    """``fn`` on every spec of a tree of dicts and pairs (a spec is a tuple
    of entries, a pair of spec trees a tuple of dicts)."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and tree and all(isinstance(t, dict) for t in tree):
        return tuple(map_specs(fn, t) for t in tree)
    return fn(tree)


def _data_entry(mesh):
    dp = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    return dp if len(dp) > 1 else dp[0]


def batch_spec(mesh, ndim: int, *, batch_axis: int = 0) -> tuple:
    """Inputs: the batch dimension split over every data axis of ``mesh``."""
    parts = [None] * ndim
    parts[batch_axis] = _data_entry(mesh)
    return tuple(parts)


def cache_specs(cfg, mesh):
    """Decode caches (the port's ``init_cache`` trees): batch over the data
    axes; K/V heads over ``"model"`` when they divide its ranks, else the
    cache's sequence over ``"model"`` (flash-decoding's split); MLA's latent
    by its channels and its rope key by sequence; Mamba's conv channels and
    SSM heads over ``"model"``."""
    dp = _data_entry(mesh)
    tp = mesh.shape["model"]

    def attn():
        if cfg.mla is not None:
            return {"latent": (None, dp, None, "model"), "k_rope": (None, dp, "model", None),
                    "index": (None,)}
        if (cfg.n_kv_heads * cfg.kv_dup) % tp == 0:
            kv = (None, dp, None, "model", None)
        else:
            kv = (None, dp, "model", None, None)  # sequence-sharded cache
        return {"k": kv, "v": kv, "index": (None,)}

    def mamba():
        return {"conv": (None, dp, None, "model"), "ssm": (None, dp, "model", None, None)}

    if cfg.family == "ssm":
        return mamba()
    if cfg.family == "hybrid":
        return (mamba(), attn())
    if cfg.moe is not None and cfg.moe.first_k_dense:
        return (attn(), attn())
    return attn()


def opt_state_specs(param_specs: dict, opt_name: str):
    """``(step spec, first moments' specs, second moments')``, leaf by leaf
    from the parameters' (a dict by leaf path): AdamW's moments as their
    parameter; Adafactor's factored rows drop the last entry, its columns
    the second to last (a 1-D leaf: rows as the leaf, columns ``(None,)``)."""

    def rows(s):
        return s[:-1] if len(s) >= 2 else s

    def cols(s):
        return s[:-2] + s[-1:] if len(s) >= 2 else (None,)

    if opt_name == "adamw":
        return (), dict(param_specs), dict(param_specs)
    return (), {k: rows(s) for k, s in param_specs.items()}, \
        {k: cols(s) for k, s in param_specs.items()}


def _entry_axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def spec_axes(spec) -> tuple:
    """The mesh axes a spec splits over, in the mesh's order of its entries."""
    return tuple(a for e in spec for a in _entry_axes(e))


def _ways(mesh, entry) -> int:
    return math.prod(mesh.shape[a] for a in _entry_axes(entry))


def shard_shape(shape, spec, mesh) -> tuple:
    """A shard's shape (GSPMD's: ``ceil(n / ranks)`` on a split dimension,
    padding included), on a mesh of ranks or an :class:`AbstractMesh`."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // _ways(mesh, e)) for n, e in zip(shape, spec))


def _block(mesh, entry) -> int:
    """This rank's block along a dimension split by ``entry``: row-major
    over the entry's axes (the first the slowest), as GSPMD numbers them."""
    idx = 0
    for a in _entry_axes(entry):
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return idx


def block_slices(shape, spec, mesh) -> tuple[tuple, tuple]:
    """``(slices, padded shape)``: the rows of a global tensor of ``shape``
    that this rank's block under ``spec`` holds, and the block's shape with
    its padding (:func:`shard_of`)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    slices, padded = [], []
    for n, e in zip(shape, spec):
        n, ways = int(n), _ways(mesh, e)
        blk = -(-n // ways)
        lo = min(_block(mesh, e) * blk, n) if ways > 1 else 0
        slices.append(slice(lo, min(lo + blk, n)))
        padded.append(blk)
    return tuple(slices), tuple(padded)


def padded_to(part: torch.Tensor, shape) -> torch.Tensor:
    """``part`` in the top corner of zeros of ``shape`` (``part`` itself, as
    a contiguous copy, where it has that shape)."""
    if tuple(part.shape) == tuple(shape):
        return part.clone(memory_format=torch.contiguous_format)
    out = torch.zeros(tuple(shape), dtype=part.dtype, device=part.device)
    out[tuple(slice(0, s) for s in part.shape)] = part
    return out


def shard_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` on
    ``mesh`` (a :class:`NamedMesh`), as GSPMD lays it out: on each split
    dimension the ``ceil(n / ranks)`` rows from ``block * ceil``, padded with
    zeros past ``n``.  A new tensor (``t`` may be freed)."""
    slices, padded = block_slices(t.shape, spec, mesh)
    return padded_to(t[slices], padded)


def valid_slices(full_shape, spec, mesh) -> tuple:
    """The slices of this rank's shard that hold the tensor (the rest is
    :func:`shard_of`'s padding)."""
    spec = tuple(spec) + (None,) * (len(full_shape) - len(spec))
    out = []
    for n, e in zip(full_shape, spec):
        blk = -(-int(n) // _ways(mesh, e))
        out.append(slice(0, max(0, min(blk, int(n) - _block(mesh, e) * blk))))
    return tuple(out)


def gather_axes_mesh(mesh, axes) -> Mesh:
    """The 1-D sub-mesh over ``axes`` (any order; taken in the mesh's)."""
    return mesh.sub(tuple(a for a in mesh.axis_names if a in set(axes)))


def assemble(parts: torch.Tensor, spec, mesh, group_axes: tuple) -> torch.Tensor:
    """The padded global tensor from every rank's shard of ``group_axes``'s
    sub-mesh, stacked in that sub-mesh's rank order (``parts`` (W, *shard));
    dimensions split over axes outside ``group_axes`` keep this rank's
    block."""
    spec = tuple(spec) + (None,) * (parts.dim() - 1 - len(spec))
    shard = parts.shape[1:]
    sizes = [mesh.shape[a] for a in group_axes]
    ways = [(_ways(mesh, e) if set(_entry_axes(e)) <= set(group_axes) else 1) for e in spec]
    full = parts.new_empty(tuple(n * w for n, w in zip(shard, ways)))
    for r in range(parts.shape[0]):
        at = dict(zip(group_axes, np.unravel_index(r, sizes)))
        idx = []
        for dim, e in enumerate(spec):
            if ways[dim] == 1:
                idx.append(slice(None))
                continue
            b = 0
            for a in _entry_axes(e):
                b = b * mesh.shape[a] + int(at[a])
            idx.append(slice(b * shard[dim], (b + 1) * shard[dim]))
        full[tuple(idx)] = parts[r]
    return full


def gather_full(t: torch.Tensor, spec, mesh, shape=None) -> torch.Tensor:
    """The inverse of :func:`shard_of`: every rank's block all-gathered over
    the axes ``spec`` splits on and put in place, trimmed to ``shape``
    (default: the padded shape).  Every rank of the mesh calls it (a
    collective); no gradient."""
    axes = spec_axes(spec)
    if axes and math.prod(mesh.shape[a] for a in axes) > 1:
        group = gather_axes_mesh(mesh, axes)
        order = tuple(a for a in mesh.axis_names if a in set(axes))
        with torch.no_grad():
            t = assemble(all_gather(group, t), spec, mesh, order)
    if shape is not None and tuple(t.shape) != tuple(shape):
        t = t[tuple(slice(0, int(n)) for n in shape)]
    return t.contiguous()

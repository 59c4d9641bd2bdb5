"""Meshes of the port: one process per shard (counterpart of the data half
of :mod:`repro.distributed.sharding`).

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

Gloo takes CUDA tensors for the three collectives used here and stages
them through host memory itself (probed on an H100 with torch 2.11.0 and
CUDA 12.8: ``all_to_all_single``, ``all_gather`` and ``all_reduce``), so
ranks that share a card pass their device tensors as they are.  A gloo
collective on CUDA tensors synchronises the card's stream: a wait that
``types.SYNCS`` does not count.  A collective that fails raises; nothing
carries on without it.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.types import SYNCS

BACKENDS = ("gloo", "nccl")

# collectives this process took part in: on card tensors (each one, on
# gloo, also waits for the card's stream: a sync ``SYNCS`` does not see),
# and on host tensors
COLLECTIVES = {"card": 0, "host": 0}


def _count(t: torch.Tensor) -> None:
    COLLECTIVES["card" if t.is_cuda else "host"] += 1


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
    _count(src)
    dist.all_gather(parts, src, group=mesh.group)
    return torch.stack(parts)


def all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Equal splits of ``t``'s leading axis: split ``i`` goes to rank ``i``,
    and split ``i`` of the result came from rank ``i``."""
    if mesh.world == 1:
        return t.clone()
    src = t.contiguous()
    out = torch.empty_like(src)
    _count(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced over the ranks, ``op`` ``"sum"`` or ``"max"`` (a new
    tensor)."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if mesh.world == 1:
        return t.clone()
    buf = t.clone()
    _count(buf)
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

"""Meshes of the port's model paths (counterpart of
:mod:`repro.launch.mesh`): the reference's production meshes and its
small test mesh as :class:`repro_torch.distributed.sharding.NamedMesh`es
over the ranks ``sharding.init_distributed`` joined.

Single pod: ``(data=16, model=16)``, 256 ranks.  Multi-pod: ``(pod=2,
data=16, model=16)``, 512 ranks; ``"pod"`` is one more data-parallel axis
(FSDP spans ``("pod", "data")``).  A mesh needs that many ranks and raises
with fewer; ``production_shape`` gives the shape and axes alone, for the
spec functions (``sharding.AbstractMesh``).
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.distributed import sharding as SH


def production_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """``(shape, axes)`` of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _joined() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape, axes, device) -> SH.NamedMesh:
    need = math.prod(shape)
    if _joined() != need:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {need} ranks; "
                         f"{_joined()} joined")
    return SH.make_mesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> SH.NamedMesh:
    shape, axes = production_shape(multi_pod=multi_pod)
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(2, 4), axes=("data", "model"), *, device="cuda") -> SH.NamedMesh:
    """A small mesh for multi-rank tests (the reference's: (2, 4) of 8)."""
    return _mesh(tuple(shape), tuple(axes), device)

"""Backend registry of the port (counterpart of :mod:`repro.core.dispatch`).

Two backends provide the engine's four primitives and the MoE block's
grouped matmul:

* ``"torch"`` — the plain PyTorch reference engine
  (:mod:`repro_torch.core.ordered_index`); runs on any device.
* ``"cuda"``  — the hand-written Hopper kernels behind
  :mod:`repro_torch.kernels.ops`.  On a CUDA tensor they launch the
  kernel or raise; only a CPU tensor takes a kernel's plain version.

``"auto"`` resolves by the tensors' device: ``cpu`` → ``"torch"``, any
other device → ``"cuda"``.  There is no fallback: a backend that cannot
run raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Backend:
    """``argsort(keys) -> perm`` — stable argsort of an int64 key vector
    (EMPTY sorts last).
    ``segmented_combine(state) -> state`` — combine adjacent equal keys of
    a key-sorted state; groups compacted to the front, EMPTY-padded.
    ``merge_sorted(a, b, assume_unique=False) -> state`` — linear merge-
    absorb of two key-sorted states into capacity ``|a| + |b|``.
    ``join_probe(a_keys, b_keys, empty) -> (pos, hit)`` — the merge join's
    probe: each sorted ``a`` key's lower bound in the sorted ``b`` keys
    (int32, clipped into b's rows) and whether it is there (bool).
    ``grouped_matmul(x, w, capacity=C) -> out`` — the expert-blocked
    product ``out[e*C + i] = x[e*C + i] @ w[e]`` of the sorted MoE
    dispatch: x ``(E*C, D)``, w ``(E, D, F)``, float32 accumulation, the
    output in x's dtype."""

    name: str
    argsort: Callable
    segmented_combine: Callable
    merge_sorted: Callable
    join_probe: Callable
    grouped_matmul: Callable


def _load_torch() -> Backend:
    from repro_torch.core import merge_join as mj
    from repro_torch.core import ordered_index as oi
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain

    return Backend(
        name="torch",
        argsort=oi.argsort_torch,
        segmented_combine=oi.segmented_combine_torch,
        merge_sorted=oi.merge_absorb_torch,
        join_probe=mj.join_probe_torch,
        grouped_matmul=grouped_matmul_plain,
    )


def _load_cuda() -> Backend:
    from repro_torch.kernels import ops

    return Backend(
        name="cuda",
        argsort=ops.argsort_keys,
        segmented_combine=ops.segmented_combine,
        merge_sorted=ops.merge_absorb_sorted,
        join_probe=ops.join_probe,
        grouped_matmul=ops.moe_grouped_matmul,
    )


_loaders: dict[str, Callable[[], Backend]] = {"torch": _load_torch, "cuda": _load_cuda}
_cache: dict[str, Backend] = {}


def registered_backends() -> tuple[str, ...]:
    return tuple(_loaders)


def resolve_backend_name(name: str | None, device) -> str:
    """``"auto"`` (or None) → the concrete backend for ``device``."""
    if name in ("auto", None):
        return "torch" if torch.device(device).type == "cpu" else "cuda"
    if name not in _loaders:
        raise KeyError(f"unknown backend {name!r}; registered: {registered_backends()}")
    return name


def get_backend(name: str | None, device) -> Backend:
    """The backend ``name`` (``"auto"``/None: by ``device``, the device of
    the tensors it will be given)."""
    name = resolve_backend_name(name, device)
    if name not in _cache:
        _cache[name] = _loaders[name]()
    return _cache[name]

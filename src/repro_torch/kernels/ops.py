"""The ``"cuda"`` backend's primitives (counterpart of
:mod:`repro.kernels.ops`): ``argsort_keys``, ``segmented_combine``,
``merge_absorb_sorted``, ``join_probe``, ``moe_grouped_matmul`` and the
bitonic foil ``merge_absorb_sorted_bitonic``.

On a CPU tensor each takes its kernel's plain version; on any other
device it launches the kernel or raises — never a quiet fallback.  Each
kernel launch made through these wrappers adds one to
``LAUNCHES[<kernel>]``, so a run can show that its main path went through
the kernels.  The reference's ``(T, N)`` tile and uint32-lane plumbing
(``_state_to_tiles``, ``_plane_to_tile``, ``_key_lanes``) and the pow-2
padding of the probe are TPU layout and have no counterpart: the kernels
take int64 keys and (N, V) planes, and width-0 planes stay width 0.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import AggState
from repro_torch.kernels import (
    bitonic_sort,
    grouped_matmul,
    merge_aggregate,
    merge_path,
    segmented_reduce,
)

# "grouped_matmul" counts the tensor-core variant, "grouped_matmul_simt" the
# CUDA-core one (grouped_matmul.variant)
LAUNCHES = {"argsort": 0, "segmented_combine": 0, "merge_absorb": 0, "join_probe": 0,
            "grouped_matmul": 0, "grouped_matmul_simt": 0, "merge_absorb_bitonic": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def argsort_keys(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort of an int64 key vector (int32 permutation)."""
    if keys.device.type == "cpu":
        return bitonic_sort.argsort_plain(keys)
    perm = bitonic_sort.argsort_cuda(keys)
    if keys.shape[0]:
        LAUNCHES["argsort"] += 1
    return perm


def segmented_combine(state: AggState) -> AggState:
    """Combine adjacent equal keys of a key-sorted state (groups compacted
    to the front, EMPTY-padded, same capacity)."""
    if state.device.type == "cpu":
        return segmented_reduce.segmented_combine_plain(state)
    out = segmented_reduce.segmented_combine_cuda(state)
    if state.capacity:
        LAUNCHES["segmented_combine"] += 1
    return out


def merge_absorb_sorted(a: AggState, b: AggState, *, assume_unique: bool = False) -> AggState:
    """Merge-absorb two key-sorted states into capacity ``|a|+|b|``."""
    if a.device.type == "cpu":
        return merge_path.merge_absorb_plain(a, b, assume_unique=assume_unique)
    out = merge_path.merge_absorb_cuda(a, b, assume_unique=assume_unique)
    LAUNCHES["merge_absorb"] += 1
    return out


def join_probe(a_keys: torch.Tensor, b_keys: torch.Tensor, empty: int):
    """Merge-join probe of the sorted ``a_keys`` in the sorted ``b_keys``:
    ``(pos, hit)`` shaped like ``a_keys``, ``pos`` clipped into b's rows
    (see :func:`repro_torch.core.merge_join.join_probe`)."""
    if a_keys.device.type == "cpu":
        return merge_path.join_probe_plain(a_keys, b_keys, empty)
    out = merge_path.join_probe_cuda(a_keys, b_keys, empty)
    if a_keys.shape[0]:
        LAUNCHES["join_probe"] += 1
    return out


def merge_absorb_sorted_bitonic(a: AggState, b: AggState) -> AggState:
    """The previous-generation merge-absorb (a bitonic merge network), kept
    as the merge-path kernel's foil: u32-domain keys only; the output has
    ``|a| + |b|`` rows, the reference's ``min(|a| + |b|, 2n)`` with ``n``
    the next power of two of the larger capacity."""
    if a.device.type == "cpu":
        return merge_aggregate.merge_absorb_bitonic_plain(a, b)
    out = merge_aggregate.merge_absorb_bitonic_cuda(a, b)
    LAUNCHES["merge_absorb_bitonic"] += 1
    return out


def moe_grouped_matmul(x: torch.Tensor, w: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """``out[e*C + i] = x[e*C + i] @ w[e]``: x ``(E*C, D)``, w ``(E, D, F)``,
    float32 accumulation, the output in x's dtype."""
    if x.device.type == "cpu":
        return grouped_matmul.grouped_matmul_plain(x, w, capacity=capacity)
    out, name = grouped_matmul.grouped_matmul_launch(x, w, capacity=capacity)
    if name is not None:
        LAUNCHES["grouped_matmul" if name == "wgmma" else "grouped_matmul_simt"] += 1
    return out

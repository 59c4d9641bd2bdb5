"""User-facing ordered-index primitives (counterpart of
:mod:`repro.core.sorted_ops`): sort, combine, absorb, merge-absorb, their
trees over many states, the in-memory group-by and finalize, each routed
through :mod:`repro_torch.core.dispatch`.

The reference's Pallas backend has no interleave kernel (its
``interleave`` falls back to the XLA rank gather), so the port's
:func:`interleave` is PyTorch ops on every device, like the reference's
XLA path."""
from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.core import ordered_index as oi
from repro_torch.core.types import AggState, rows_to_state, take


def _backend(backend: str, state: AggState):
    return dispatch.get_backend(backend, state.device)


def sort_state(state: AggState, *, backend: str = "auto") -> AggState:
    """Key-sort all rows of a state; EMPTY rows sink to the end."""
    return take(state, _backend(backend, state).argsort(state.keys))


def segmented_combine(state: AggState, *, backend: str = "auto") -> AggState:
    """Combine adjacent equal-key rows of a key-sorted state (groups
    compacted to the front, EMPTY tail, same capacity)."""
    return _backend(backend, state).segmented_combine(state)


def absorb(state: AggState, *, backend: str = "auto") -> AggState:
    """sort + combine: canonicalize any state to sorted/compacted form."""
    return segmented_combine(sort_state(state, backend=backend), backend=backend)


def merge_absorb(table: AggState, incoming: AggState, *, backend: str = "auto",
                 assume_unique: bool = False) -> AggState:
    """Batched insert of the key-sorted ``incoming`` into the key-sorted
    ``table``: a linear merge, capacity ``|table| + |incoming|``."""
    return _backend(backend, table).merge_sorted(
        table, incoming, assume_unique=assume_unique)


def interleave(a: AggState, b: AggState) -> AggState:
    """Linear merge of two key-sorted states WITHOUT combining duplicates:
    the raw sorted multiset union, capacity ``|a| + |b|``, EMPTY rows
    ranked to the tail (the traditional merge levels that defer
    aggregation, Fig 2 top, are trees of it)."""
    if a.capacity == 0 or b.capacity == 0:
        return b if a.capacity == 0 else a
    return oi.interleave_sorted(a, b)


def _merge_tree(states: list[AggState], pair_fn) -> AggState:
    """Balanced binary tree reduction over >= 1 states with ``pair_fn``
    (an odd state is carried to the next round)."""
    if not states:
        raise ValueError("merge tree needs at least one state")
    states = list(states)
    while len(states) > 1:
        nxt = [pair_fn(states[i], states[i + 1]) for i in range(0, len(states) - 1, 2)]
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    return states[0]


def merge_absorb_many(states: list[AggState], *, backend: str = "auto",
                      assume_unique: bool = False) -> AggState:
    """Balanced tree of merge-absorbs over key-sorted states (the hash
    splice, the traditional merge's aggregating groups); the result's
    capacity is the summed input capacity."""
    return _merge_tree(list(states), lambda a, b: merge_absorb(
        a, b, backend=backend, assume_unique=assume_unique))


def interleave_many(states: list[AggState]) -> AggState:
    """Balanced tree of non-combining merges: the raw sorted multiset union
    of key-sorted states, capacity the summed input capacity."""
    return _merge_tree(list(states), interleave)


def sorted_groupby(keys: torch.Tensor, payload: torch.Tensor | None = None, *, key_dtype,
                   backend: str = "auto", widths=None) -> AggState:
    """One-shot group-by of int64 keys in memory (the paper's O <= M case,
    Fig 6): absorb the rows; the output is key-sorted."""
    return absorb(rows_to_state(keys, payload, key_dtype=key_dtype, widths=widths),
                  backend=backend)


def unique_count(state: AggState) -> torch.Tensor:
    """Valid groups of a state, as a device scalar."""
    return state.occupancy()


def finalize(state: AggState, aggs=("count", "sum", "min", "max", "avg")) -> dict:
    """Accumulator → user-facing aggregate columns (tensors)."""
    out = {"key": state.keys}
    valid = state.valid()[:, None]
    for a in aggs:
        if a == "count":
            out["count"] = state.count
        elif a == "sum":
            out["sum"] = state.sum
        elif a == "min":
            out["min"] = torch.where(valid, state.min, 0.0)
        elif a == "max":
            out["max"] = torch.where(valid, state.max, 0.0)
        elif a == "avg":
            out["avg"] = state.sum / state.count.clamp(min=1).to(torch.float32)[:, None]
        else:
            raise ValueError(f"unknown aggregate {a!r}")
    return out

"""User-facing ordered-index primitives (counterpart of
:mod:`repro.core.sorted_ops`): sort, combine, absorb, merge-absorb and
finalize, each routed through :mod:`repro_torch.core.dispatch`."""
from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.core.types import AggState, take


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

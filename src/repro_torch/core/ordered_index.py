"""The ordered in-memory index engine in plain PyTorch — the port's
reference backend (counterpart of :mod:`repro.core.ordered_index`).

A batched insert into the ordered index is a linear merge of two sorted
key vectors followed by a segmented combine of the now-adjacent equal
keys.  These functions are the plain versions the ``"torch"`` backend
runs and the CUDA kernels of :mod:`repro_torch.kernels` are held against.
The reference's no-scatter rule was a TPU concern: here the combine uses
``cumsum`` group ids with ``index_add_``/``scatter_reduce_``.

:class:`OrderedIndex` is the typed engine layer over any backend of the
registry.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.types import AggState, concat_states, empty_like, empty_state, take

_INF = float("inf")


def argsort_torch(keys: torch.Tensor) -> torch.Tensor:
    """Stable key argsort (int32 permutation); EMPTY, the domain's top,
    sorts last."""
    return torch.argsort(keys, stable=True).to(torch.int32)


# ---------------------------------------------------------------------------
# linear merge of two sorted key vectors
# ---------------------------------------------------------------------------


def merge_ranks(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """Output positions of two *sorted* key vectors in merged order (``a``
    precedes ``b`` on ties) — a permutation of ``range(|a|+|b|)``."""
    na, nb = a_keys.shape[0], b_keys.shape[0]
    pos_a = torch.arange(na, device=a_keys.device) + torch.searchsorted(b_keys, a_keys)
    pos_b = torch.arange(nb, device=b_keys.device) + torch.searchsorted(
        a_keys, b_keys, right=True)
    return pos_a, pos_b


def merge_gather_indices(a_keys: torch.Tensor, b_keys: torch.Tensor) -> torch.Tensor:
    """``src[k]``: the row of ``concat(a, b)`` that lands at merged position
    ``k``, found by inverting ``pos_a`` with one more binary search."""
    na, nb = a_keys.shape[0], b_keys.shape[0]
    pos_a, _ = merge_ranks(a_keys, b_keys)
    k = torch.arange(na + nb, device=a_keys.device)
    ca = torch.searchsorted(pos_a, k)
    ca_c = ca.clamp(max=max(na - 1, 0))
    take_a = pos_a[ca_c] == k
    ib = (k - ca).clamp(max=max(nb - 1, 0))
    return torch.where(take_a, ca_c, na + ib)


def interleave_sorted(a: AggState, b: AggState) -> AggState:
    """Merge two key-sorted states into one sorted state of capacity
    ``|a|+|b|`` (duplicates adjacent, not yet combined)."""
    src = merge_gather_indices(a.keys, b.keys)
    return concat_states(a, b).map(lambda x: x.index_select(0, src))


# ---------------------------------------------------------------------------
# segmented combine and compaction
# ---------------------------------------------------------------------------


def segmented_combine_torch(state: AggState) -> AggState:
    """Combine adjacent equal-key rows of a key-sorted state.  Groups are
    compacted to the front in key order; the tail is EMPTY/neutral.  EMPTY
    rows never join a group."""
    n = state.capacity
    if n == 0:
        return state
    k = state.keys
    valid = state.valid()
    same_prev = torch.zeros_like(valid)
    same_prev[1:] = k[1:] == k[:-1]
    heads = valid & ~same_prev
    gid = torch.cumsum(heads, 0) - 1
    dst = torch.where(valid, gid, n)  # row n is a discarded trash row
    dst_head = torch.where(heads, gid, n)
    out = empty_like(state, n + 1)
    out.keys.scatter_(0, dst_head, k)
    out.count.index_add_(0, dst, state.count)
    out.sum.index_add_(0, dst, state.sum)
    if state.min.shape[1]:
        out.min.scatter_reduce_(0, dst[:, None].expand_as(state.min), state.min, "amin")
    if state.max.shape[1]:
        out.max.scatter_reduce_(0, dst[:, None].expand_as(state.max), state.max, "amax")
    return out.map(lambda x: x[:n])


def compact_indices(keep: torch.Tensor):
    """Gather indices compacting the ``keep``-flagged rows to the front:
    ``src[j]`` is the row of the j-th kept row, ``live[j]`` whether output
    row j holds one."""
    n = keep.shape[0]
    csum = torch.cumsum(keep.to(torch.int64), 0)
    j = torch.arange(n, device=keep.device)
    src = torch.searchsorted(csum, j + 1)
    return src.clamp(max=n - 1), j < csum[-1]


def _compact_rows(state: AggState, keep: torch.Tensor) -> AggState:
    pos, live = compact_indices(keep)

    def take_live(col, fill):
        v = col.index_select(0, pos)
        mask = live.reshape((-1,) + (1,) * (v.dim() - 1))
        return torch.where(mask, v, torch.tensor(fill, dtype=v.dtype, device=v.device))

    return AggState(
        keys=take_live(state.keys, state.empty),
        count=take_live(state.count, 0),
        sum=take_live(state.sum, 0.0),
        min=take_live(state.min, _INF),
        max=take_live(state.max, -_INF),
        key_dtype=state.key_dtype,
    )


def pair_combine_torch(merged: AggState) -> AggState:
    """Absorb duplicates of a sorted state whose keys appear at most twice
    (the merge of two duplicate-free states): one shifted compare and one
    compaction gather."""
    n = merged.capacity
    if n == 0:
        return merged
    k = merged.keys
    valid = merged.valid()
    eq = k[1:] == k[:-1]
    same_next = torch.zeros_like(valid)
    same_next[:-1] = eq
    same_next &= valid
    same_prev = torch.zeros_like(valid)
    same_prev[1:] = eq
    same_prev &= valid
    heads = valid & ~same_prev

    def shift_up(x, fill):
        pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x[1:], pad], 0)

    m = same_next
    mcol = m[:, None]
    cnt = merged.count + torch.where(m, shift_up(merged.count, 0), 0)
    ssum = merged.sum + torch.where(mcol, shift_up(merged.sum, 0.0), 0.0)
    smin = torch.where(mcol, torch.minimum(merged.min, shift_up(merged.min, _INF)), merged.min)
    smax = torch.where(mcol, torch.maximum(merged.max, shift_up(merged.max, -_INF)), merged.max)
    return _compact_rows(AggState(k, cnt, ssum, smin, smax, merged.key_dtype), heads)


def merge_absorb_torch(a: AggState, b: AggState, *, assume_unique: bool = False) -> AggState:
    """Linear merge-absorb of two key-sorted states into capacity
    ``|a|+|b|``; ``assume_unique`` (both inputs duplicate-free) licenses
    the pair-combine."""
    if a.capacity == 0 or b.capacity == 0:
        merged = concat_states(a, b)
        return merged if assume_unique else segmented_combine_torch(merged)
    merged = interleave_sorted(a, b)
    if assume_unique:
        return pair_combine_torch(merged)
    return segmented_combine_torch(merged)


# ---------------------------------------------------------------------------
# the typed engine layer
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OrderedIndex:
    """A fixed-capacity state carrying the engine's invariant in its type:
    keys ascending, valid keys duplicate-free, an EMPTY-padded suffix.

    ``from_unsorted`` establishes the invariant (the only full argsort);
    ``empty``, ``merge_absorb`` and ``trim`` preserve it; ``wrap`` trusts a
    caller that keeps it.  The operations run on the backend of the
    registry (:mod:`repro_torch.core.dispatch`), by default the one of the
    state's device."""

    state: AggState

    @property
    def capacity(self) -> int:
        return self.state.capacity

    @property
    def width(self) -> int:
        return self.state.width

    @property
    def keys(self) -> torch.Tensor:
        return self.state.keys

    def occupancy(self) -> torch.Tensor:
        return self.state.occupancy()

    @classmethod
    def empty(cls, capacity: int, width: int, *, key_dtype=np.uint32,
              device="cuda") -> "OrderedIndex":
        return cls(empty_state(capacity, width, key_dtype=key_dtype, device=device))

    @classmethod
    def wrap(cls, state: AggState) -> "OrderedIndex":
        """Trust the caller that ``state`` already satisfies the invariant."""
        return cls(state)

    @classmethod
    def from_unsorted(cls, state: AggState, *, backend: str = "auto") -> "OrderedIndex":
        """Canonicalize arbitrary rows: full argsort + combine."""
        be = dispatch.get_backend(backend, state.device)
        return cls(be.segmented_combine(take(state, be.argsort(state.keys))))

    def merge_absorb(self, other: "OrderedIndex", *, backend: str = "auto") -> "OrderedIndex":
        """Batched insert (§3.4): a linear merge, never a full sort, into
        capacity ``self.capacity + other.capacity``.  Both sides are
        duplicate-free, so the absorb is a pair-combine."""
        be = dispatch.get_backend(backend, self.state.device)
        return OrderedIndex(be.merge_sorted(self.state, other.state, assume_unique=True))

    def trim(self, capacity: int) -> "OrderedIndex":
        """Keep the first ``capacity`` rows (the smallest keys); callers
        check that the occupancy fits first."""
        return OrderedIndex(self.state.map(lambda x: x[:capacity]))

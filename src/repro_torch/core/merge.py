"""Merging for external in-sort aggregation (counterpart of
:mod:`repro.core.merge`): the traditional F-way merge and the paper's wide
merge of the final merge step (§4).

Traditional merging is limited to fan-in F; aggregation during a merge
step caps its output at the final output size O.  The wide merge keeps an
ordered in-memory index over the active key range absorbs pages from
any number of runs through one shared input buffer, guided by a priority
queue over each run's next unread page's low key; keys below the merge
frontier (the least key any run can still deliver) are final and stream
out of the left edge of the index.

The reference runs the page loop as a ``while_loop``.  Here the page count
is known up front — Σ⌈lens/P⌉, one readback of the run lengths, none where
the caller knows them on the host — so the loop runs exactly that many
pages, and the priority queue, the chosen run, the cursors and the
emission cursor all stay on the device: the loop pays no per-page host
sync.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import sorted_ops
from repro_torch.core.run_generation import Run
from repro_torch.core.types import (
    FIELDS,
    AggState,
    ExecConfig,
    SpillStats,
    concat_states,
    device_ints,
    empty_like,
    empty_state,
    host_ints,
)


# ---------------------------------------------------------------------------
# stacked run storage ("temporary storage")
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunStore:
    """R runs padded to a common page-aligned capacity C."""

    state: AggState  # fields with leading dims (R, C)
    lens: torch.Tensor  # (R,) int64


def stack_runs(runs: list[Run], page_rows: int) -> RunStore:
    """Pad (or trim past their length) the runs to one page-aligned
    capacity and stack them."""
    cap = max(1, max(r.length for r in runs))
    cap = int(math.ceil(cap / page_rows) * page_rows)
    padded = []
    for r in runs:
        s = r.state
        if s.capacity < cap:
            s = concat_states(s, empty_like(s, cap - s.capacity))
        else:
            s = s.map(lambda x: x[:cap])
        padded.append(s)
    state = AggState(*(torch.stack([getattr(s, f) for s in padded]) for f in FIELDS),
                     key_dtype=padded[0].key_dtype)
    lens = torch.tensor([r.length for r in runs], dtype=torch.int64, device=state.device)
    return RunStore(state=state, lens=lens)


def fragments_to_store(recv: AggState, world: int, quota: int):
    """``world`` concatenated sorted fragments of ``quota`` rows each (an
    exchange's receive buffer, fields ``(world·quota, ...)``) as the
    stacked run store the wide merge takes: fields reshaped to ``(world,
    quota, ...)`` (views) and each fragment's valid rows (fragments are
    left-packed and EMPTY-padded), a device tensor.  ``quota`` must be a
    multiple of the merge's page."""
    store = recv.map(lambda x: x.reshape((world, quota) + tuple(x.shape[1:])))
    return store, store.valid().sum(1)


def _page_of(store: AggState, r: torch.Tensor, start: torch.Tensor, page_rows: int) -> AggState:
    """Gather one page (P rows) of run ``r`` — device scalars — into the
    shared input buffer."""
    R, C = store.keys.shape
    rows = r * C + start + torch.arange(page_rows, device=store.device)
    return store.map(lambda x: x.reshape((R * C,) + tuple(x.shape[2:])).index_select(0, rows))


# ---------------------------------------------------------------------------
# traditional F-way merge (with or without aggregation during the merge)
# ---------------------------------------------------------------------------


def _merge_group(states: tuple[AggState, ...], *, aggregate: bool, backend: str) -> AggState:
    """Merge a group of key-sorted runs with a balanced tree of linear
    merges: merge-absorbs with ``aggregate`` (duplicates combine as they
    merge), interleaves without (the raw sorted multiset, for plans that
    defer aggregation, Fig 2 top)."""
    states = list(states)
    if len(states) == 1 and aggregate:
        # a lone run may carry intra-run duplicates (traditional policy):
        # combining a sorted state needs no merge
        return sorted_ops.segmented_combine(states[0], backend=backend)
    if aggregate:
        return sorted_ops.merge_absorb_many(states, backend=backend)
    return sorted_ops.interleave_many(states)


def _pad_group(states: tuple[AggState, ...]) -> tuple[AggState, ...]:
    """Pad group members to their common largest capacity, as the
    reference does before its compiled merge tree (the capacities decide
    the merged state's padding)."""
    cap = max(s.capacity for s in states)
    return tuple(s if s.capacity == cap else concat_states(s, empty_like(s, cap - s.capacity))
                 for s in states)


def traditional_merge(runs: list[Run], cfg: ExecConfig, *, aggregate_during_merge: bool,
                      stats: SpillStats, backend: str = "auto", stop_at: int = 1) -> list[Run]:
    """Merge runs F at a time until ``stop_at`` or fewer remain.  Every
    merge step's output is written back and counted as spill, except the
    final step when ``stop_at == 1`` (it streams to the consumer, Fig 2)."""
    F = cfg.fanin
    while len(runs) > stop_at:
        nxt: list[Run] = []
        level_groups = [runs[i:i + F] for i in range(0, len(runs), F)]
        for group in level_groups:
            if len(group) == 1:  # a singleton is carried over: no rewrite
                nxt.append(group[0])
                continue
            merged = _merge_group(_pad_group(tuple(g.state for g in group)),
                                  aggregate=aggregate_during_merge, backend=backend)
            (length,) = host_ints(merged.occupancy())
            nxt.append(Run(state=merged, length=length))
            stats.merge_steps += 1
            is_final = len(level_groups) == 1 and len(nxt) <= stop_at
            if not is_final:
                stats.rows_spilled_merge += length
        stats.merge_levels += 1
        runs = nxt
    return runs


def final_merge_traditional(runs: list[Run], cfg: ExecConfig, *, aggregate: bool,
                            stats: SpillStats, backend: str = "auto") -> AggState:
    """Reduce to at most F runs with traditional merging, then stream the
    final merge (never spilled), aggregating in the stream (Fig 2 top)."""
    runs = traditional_merge(runs, cfg, aggregate_during_merge=aggregate, stats=stats,
                             backend=backend, stop_at=cfg.fanin)
    out = _merge_group(_pad_group(tuple(r.state for r in runs)), aggregate=True,
                       backend=backend)
    stats.merge_steps += 1
    stats.merge_levels += 1
    return out


def trim_to_capacity(state: AggState, capacity: int):
    """Trim a compacted state to ``capacity`` rows; ``dropped`` (a device
    bool) flags that live rows were cut."""
    dropped = state.occupancy() > capacity
    return state.map(lambda x: x[:capacity]), dropped


def wide_merge_device(store: AggState, lens, *, page_rows: int, index_rows: int,
                      out_capacity: int | None = None, backend: str = "auto",
                      out: AggState | None = None):
    """The page loop over a stacked run store (fields ``(R, C, ...)``, runs
    sorted and EMPTY-padded, ``C`` a multiple of ``page_rows``).

    ``lens`` are the run lengths: a device tensor, whose page count the
    loop reads back once, or host ints, which spare it that readback.
    ``out`` is a caller-provided output buffer (all EMPTY, of the store's
    key dtype and plane widths; the merge-on-read snapshot emits into a
    fresh one): the rows are written into its tensors and it is returned.
    Without it a buffer of ``out_capacity`` rows is allocated here.

    Returns ``(out, rows_emitted, pages_read, max_index_occupancy,
    overflow, dropped)``; ``pages_read`` is a host int, the rest are device
    tensors.  ``dropped`` flags lost rows (index past its hard capacity or
    output past the output's capacity), ``overflow`` an index past
    ``index_rows``."""
    R, C = store.keys.shape
    P = page_rows
    W = index_rows + P
    dev = store.device
    empty = store.empty
    if out is not None:
        if out.key_dtype != store.key_dtype or out.widths != store.widths:
            raise ValueError(
                f"caller-provided out buffer (dtype {out.key_dtype}, widths {out.widths}) "
                f"does not match the run store (dtype {store.key_dtype}, widths "
                f"{store.widths})")
        out_capacity = out.capacity
    elif out_capacity is None:
        raise ValueError("wide_merge_device needs out= or out_capacity=")
    if isinstance(lens, torch.Tensor):
        n_pages = (lens.to(torch.int64) + P - 1) // P
        (total_pages,) = host_ints(n_pages.sum())  # the loop's one readback
    else:
        host_pages = [(int(n) + P - 1) // P for n in lens]
        total_pages = sum(host_pages)
        n_pages = device_ints(host_pages, dev)
    arange_R = torch.arange(R, device=dev)
    ar_WP = torch.arange(W + P, device=dev)
    ar_W = torch.arange(W, device=dev)

    def next_low_keys(cursors):
        pos = (cursors * P).clamp(0, C - 1)
        k = store.keys[arange_R, pos]
        return torch.where(cursors < n_pages, k, empty)

    # one extra trash row takes the scatter of rows that are not emitted
    caller_out, out = out, empty_state(out_capacity + 1, store.width,
                                       key_dtype=store.key_dtype, widths=store.widths,
                                       device=dev)
    index = empty_state(W, store.width, key_dtype=store.key_dtype, widths=store.widths,
                        device=dev)
    cursors = torch.zeros(R, dtype=torch.int64, device=dev)
    out_cur = torch.zeros((), dtype=torch.int64, device=dev)
    max_occ = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    one = torch.ones(1, dtype=torch.int64, device=dev)
    for _ in range(total_pages):
        low = next_low_keys(cursors)
        rstar = torch.argmin(low)  # exhausted runs hold EMPTY and lose
        page = _page_of(store, rstar, cursors[rstar] * P, P)
        # pages may carry intra-run duplicates: the general combine
        merged = sorted_ops.merge_absorb(index, page, backend=backend)  # W + P rows
        cursors.index_add_(0, rstar.reshape(1), one)
        frontier = next_low_keys(cursors).min()
        occ = merged.occupancy()
        e = (merged.keys < frontier).sum()
        # emit the final prefix out of the left edge of the index
        dst = torch.where(ar_WP < e, out_cur + ar_WP, out_capacity).clamp(max=out_capacity)
        for o, m in zip((out.keys, out.count, out.sum, out.min, out.max),
                        (merged.keys, merged.count, merged.sum, merged.min, merged.max)):
            o.index_copy_(0, dst, m)
        out_cur = out_cur + e
        # shift the index left by e (drop emitted rows), trim back to W
        src = (ar_W + e).clamp(max=W + P - 1)
        shifted = merged.map(lambda x: x.index_select(0, src))
        live = ar_W < occ - e
        index = AggState(torch.where(live, shifted.keys, empty), shifted.count, shifted.sum,
                         shifted.min, shifted.max, store.key_dtype)
        resident = occ - e
        max_occ = torch.maximum(max_occ, resident)
        overflow = overflow | (resident > index_rows)
    dropped = (max_occ > W) | (out_cur > out_capacity)
    out = out.map(lambda x: x[:out_capacity])
    if caller_out is not None:
        for f in FIELDS:
            getattr(caller_out, f).copy_(getattr(out, f))
        out = caller_out
    return out, out_cur, total_pages, max_occ, overflow, dropped


def wide_merge(runs: list[Run], cfg: ExecConfig, *, stats: SpillStats,
               out_capacity: int | None = None, index_rows: int | None = None,
               backend: str = "auto") -> AggState:
    """The final merge step with unbounded fan-in (§4) over a list of
    runs; it never spills.  ``index_rows`` defaults to the memory
    allocation M.  Raises where the merge dropped rows, naming which of
    its two limits was passed; one readback of the merge's counters."""
    store = stack_runs(runs, cfg.page_rows)
    total_in = int(sum(r.length for r in runs))
    if out_capacity is None:
        out_capacity = total_in
    index_rows = index_rows or cfg.memory_rows
    out, out_cur, pages_read, max_occ, overflow, dropped = wide_merge_device(
        store.state, store.lens, page_rows=cfg.page_rows, index_rows=index_rows,
        out_capacity=out_capacity, backend=backend)
    emitted, max_occ, overflow, dropped, occ_out = host_ints(
        out_cur, max_occ, overflow, dropped, out.occupancy())
    if dropped:
        w_cap = index_rows + cfg.page_rows
        if max_occ > w_cap:
            cause = (f"the merge index overflowed (resident {max_occ} > index_rows + "
                     f"page_rows = {w_cap})")
        else:
            cause = f"the output overran its capacity (emitted {emitted} > {out_capacity})"
        raise RuntimeError(
            f"wide merge during finalize dropped rows: {cause}; merge fewer runs at once "
            "(pre-merge levels) or raise index_rows / the output estimate")
    stats.merge_steps += 1
    stats.merge_levels += 1
    stats.pages_read += pages_read
    stats.max_index_occupancy = max(stats.max_index_occupancy, max_occ)
    stats.index_overflowed = bool(overflow) or stats.index_overflowed
    stats.rows_emitted += emitted
    # the merge emits every distinct key once, never more rows than the
    # runs held
    assert emitted <= total_in, (emitted, total_in)
    if out_capacity >= total_in:  # nothing could have been dropped
        assert emitted == occ_out, (emitted, occ_out)
    return out

"""The wide merge of the final merge step (§4) — counterpart of
:func:`repro.core.merge.wide_merge_device` and its helpers.

An ordered in-memory index over the active key range absorbs pages from
any number of runs through one shared input buffer, guided by a priority
queue over each run's next unread page's low key; keys below the merge
frontier (the least key any run can still deliver) are final and stream
out of the left edge of the index.

The reference runs the page loop as a ``while_loop``.  Here the page count
is known up front — Σ⌈lens/P⌉, one readback of the run lengths — so the
loop runs exactly that many pages, and the priority queue, the chosen run,
the cursors and the emission cursor all stay on the device: the loop pays
no per-page host sync.
"""
from __future__ import annotations

import torch

from repro_torch.core import sorted_ops
from repro_torch.core.types import AggState, empty_state, host_ints


def _page_of(store: AggState, r: torch.Tensor, start: torch.Tensor, page_rows: int) -> AggState:
    """Gather one page (P rows) of run ``r`` — device scalars — into the
    shared input buffer."""
    R, C = store.keys.shape
    rows = r * C + start + torch.arange(page_rows, device=store.device)
    return store.map(lambda x: x.reshape((R * C,) + tuple(x.shape[2:])).index_select(0, rows))


def trim_to_capacity(state: AggState, capacity: int):
    """Trim a compacted state to ``capacity`` rows; ``dropped`` (a device
    bool) flags that live rows were cut."""
    dropped = state.occupancy() > capacity
    return state.map(lambda x: x[:capacity]), dropped


def wide_merge_device(store: AggState, lens: torch.Tensor, *, page_rows: int,
                      index_rows: int, out_capacity: int, backend: str = "auto"):
    """The page loop over a stacked run store (fields ``(R, C, ...)``, runs
    sorted and EMPTY-padded, ``C`` a multiple of ``page_rows``).

    Returns ``(out, rows_emitted, pages_read, max_index_occupancy,
    overflow, dropped)``; ``pages_read`` is a host int, the rest are device
    tensors.  ``dropped`` flags lost rows (index past its hard capacity or
    output past ``out_capacity``), ``overflow`` an index past
    ``index_rows``."""
    R, C = store.keys.shape
    P = page_rows
    W = index_rows + P
    dev = store.device
    empty = store.empty
    n_pages = (lens.to(torch.int64) + P - 1) // P
    (total_pages,) = host_ints(n_pages.sum())  # the loop's one readback
    arange_R = torch.arange(R, device=dev)
    ar_WP = torch.arange(W + P, device=dev)
    ar_W = torch.arange(W, device=dev)

    def next_low_keys(cursors):
        pos = (cursors * P).clamp(0, C - 1)
        k = store.keys[arange_R, pos]
        return torch.where(cursors < n_pages, k, empty)

    # one extra trash row takes the scatter of rows that are not emitted
    out = empty_state(out_capacity + 1, store.width, key_dtype=store.key_dtype,
                      widths=store.widths, device=dev)
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
    return out, out_cur, total_pages, max_occ, overflow, dropped

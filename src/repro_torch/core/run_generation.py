"""Run generation for external in-sort aggregation (counterpart of
:mod:`repro.core.run_generation`, paper §3): the host-loop reference path.

Read-sort-write cycles with three spill policies, the paper's comparison
space:

* ``traditional`` — fill memory with raw rows, sort, write a run of
  exactly M rows (Fig 2 top: no reduction before the final merge);
* ``inrun_dedup`` — the same, but duplicates within the run combine
  before it is written (Bitton/DeWitt, Fig 2 bottom);
* ``early_agg`` — every batch is sorted, deduped and merged into the
  ordered in-memory index; a run is written once M distinct keys are
  resident, and nothing spills when the output fits (Fig 6).

:func:`generate_runs_rs` is replacement selection with the ordered index
(§3.3): two tables model the partitioned b-tree, the open run's partition
holding keys at or above the eviction frontier, the next run's partition
keys below it.  Its steps (:func:`rs_split_absorb`, :func:`rs_evict_step`)
are shared with the device pipeline (:mod:`repro_torch.core.pipeline`).

The host decides per batch whether to flush, as the paper's I/O loop
does: each decision reads an occupancy back (counted in
``types.SYNCS``).  The pipeline runs the same policies with its run
bookkeeping on the host too, over a stacked run store.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatch, sorted_ops
from repro_torch.core.types import (
    AggState,
    ExecConfig,
    SpillStats,
    canon_keys,
    canon_payload,
    concat_states,
    empty_like,
    empty_state,
    host_ints,
    keys_to_torch,
    resolve_device,
    rows_to_state,
    zero_key,
)


@dataclasses.dataclass
class Run:
    """One sorted, EMPTY-padded run on temporary storage."""

    state: AggState
    length: int  # occupied rows


def _absorb_batch(table: AggState, batch_keys: torch.Tensor, batch_payload, *,
                  backend: str):
    """One read-sort-write step: sort and dedupe the batch (paper §5) and
    merge it into the ordered index (both duplicate-free: a linear merge
    and a pair-combine).  Returns the merged index and its occupancy (a
    device scalar)."""
    batch = sorted_ops.absorb(
        rows_to_state(batch_keys, batch_payload, key_dtype=table.key_dtype,
                      widths=table.widths), backend=backend)
    merged = sorted_ops.merge_absorb(table, batch, backend=backend, assume_unique=True)
    return merged, merged.occupancy()


def _sort_chunk(keys: torch.Tensor, payload, capacity: int, *, key_dtype, dedup: bool,
                backend: str, widths=None):
    """Sort (and with ``dedup`` combine) one chunk, padded to the run
    capacity.  Chunks come at most ``capacity`` rows: trimming would drop
    rows silently."""
    state = rows_to_state(keys, payload, key_dtype=key_dtype, widths=widths)
    assert state.capacity <= capacity, (
        f"chunk of {state.capacity} rows exceeds run capacity {capacity}")
    if dedup:
        state = sorted_ops.absorb(state, backend=backend)
    else:
        state = sorted_ops.sort_state(state, backend=backend)
    if capacity > state.capacity:
        state = concat_states(state, empty_like(state, capacity - state.capacity))
    return state, state.occupancy()


def _np_chunks(keys: np.ndarray, payload: np.ndarray | None, size: int, device):
    """The input in ``size``-row batches on ``device``, the last one padded
    with EMPTY (fixed shapes, as in the reference).  The whole input
    moves to the device in one copy."""
    n = keys.shape[0]
    t = -(-n // size)
    padn = t * size - n
    if padn:
        # EMPTY of the host domain: all ones
        keys = np.concatenate([keys, np.full((padn,), np.iinfo(keys.dtype).max, keys.dtype)])
        if payload is not None:
            payload = np.concatenate([payload, np.zeros((padn,) + payload.shape[1:],
                                                        payload.dtype)])
    kt = keys_to_torch(keys, device)
    pt = None if payload is None else torch.from_numpy(np.ascontiguousarray(payload)).to(device)
    for b in range(t):
        rows = slice(b * size, (b + 1) * size)
        yield kt[rows], None if pt is None else pt[rows]


def generate_runs(keys, payload, cfg: ExecConfig, *, policy: str = "early_agg",
                  backend: str = "auto", widths=None, device="cuda"):
    """Consume an unsorted input; return ``(runs, resident_table, stats)``.

    ``resident_table`` is not None only for ``early_agg`` when no run was
    written: the operation completed in memory (Fig 6) and the table is
    the result."""
    keys, payload = canon_keys(keys), canon_payload(payload)
    dev = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend, dev)
    width = 0 if payload is None else payload.shape[1]
    M, B = cfg.memory_rows, cfg.batch_rows
    kd = keys.dtype
    stats = SpillStats()
    runs: list[Run] = []
    if policy in ("traditional", "inrun_dedup"):
        # memory buffers M raw rows; sort (and dedup) on write
        for ck, cp in _np_chunks(keys, payload, M, dev):
            state, occ = _sort_chunk(ck, cp, M, key_dtype=kd,
                                     dedup=policy == "inrun_dedup", backend=backend,
                                     widths=widths)
            (length,) = host_ints(occ)
            runs.append(Run(state=state, length=length))
            stats.rows_spilled_run_generation += length
            stats.runs_generated += 1
        return runs, None, stats
    if policy != "early_agg":
        raise ValueError(f"unknown run-generation policy {policy!r}")
    # early aggregation: the ordered in-memory index absorbs duplicates
    table = empty_state(M, width, key_dtype=kd, widths=widths, device=dev)
    for ck, cp in _np_chunks(keys, payload, B, dev):
        merged, occ = _absorb_batch(table, ck, cp, backend=backend)  # capacity M + B
        (n,) = host_ints(occ)
        if n > M:
            # memory full: the whole index content becomes one sorted run
            runs.append(Run(state=merged, length=n))
            stats.rows_spilled_run_generation += n
            stats.runs_generated += 1
            table = empty_state(M, width, key_dtype=kd, widths=widths, device=dev)
        else:
            table = merged.map(lambda x: x[:M])
    if not runs:
        return [], table, stats
    (occ,) = host_ints(table.occupancy())  # flush the final partial run
    if occ > 0:
        runs.append(Run(state=concat_states(table, empty_like(table, B)), length=occ))
        stats.rows_spilled_run_generation += occ
        stats.runs_generated += 1
    return runs, None, stats


# ---------------------------------------------------------------------------
# replacement selection with an ordered index (§3.3)
# ---------------------------------------------------------------------------


def _mask_state(state: AggState, keep: torch.Tensor) -> AggState:
    kc = keep[:, None]
    return AggState(
        keys=torch.where(keep, state.keys, state.empty),
        count=torch.where(keep, state.count, 0),
        sum=torch.where(kc, state.sum, 0.0),
        min=torch.where(kc, state.min, float("inf")),
        max=torch.where(kc, state.max, float("-inf")),
        key_dtype=state.key_dtype,
    )


def rs_split_absorb(run_table: AggState, next_table: AggState, frontier: torch.Tensor,
                    batch: AggState, *, backend: str = "auto"):
    """Split one **sorted, deduped** batch at the eviction frontier and
    absorb each half into its table (no host sync)."""
    valid = batch.valid()
    below = valid & (batch.keys < frontier)
    n_lo = below.sum()
    # the `hi` suffix rolls left past the masked `lo` prefix, restoring the
    # sorted, EMPTY-padded layout merge_absorb needs
    hi = _mask_state(batch, valid & ~below)
    src = (torch.arange(batch.capacity, device=batch.device) + n_lo) % batch.capacity
    hi = hi.map(lambda x: x.index_select(0, src))
    lo = _mask_state(batch, below)
    cap_r, cap_n = run_table.capacity, next_table.capacity
    run_table = sorted_ops.merge_absorb(
        run_table, hi, backend=backend, assume_unique=True).map(lambda x: x[:cap_r])
    next_table = sorted_ops.merge_absorb(
        next_table, lo, backend=backend, assume_unique=True).map(lambda x: x[:cap_n])
    return run_table, next_table


def rs_evict_step(run_table: AggState, quantum: int):
    """Advance the eviction scan: pop the lowest ``quantum`` rows.  Returns
    ``(evicted, rest, frontier, n_evicted)``; the frontier of an eviction
    that found nothing is the domain's zero."""
    cap = run_table.capacity
    dev = run_table.device
    evicted = run_table.map(lambda x: x[:quantum])
    src = (torch.arange(cap, device=dev) + quantum).clamp(max=cap - 1)
    rest = run_table.map(lambda x: x.index_select(0, src))
    live = torch.arange(cap, device=dev) < (run_table.occupancy() - quantum).clamp(min=0)
    rest = _mask_state(rest, live)
    valid = evicted.valid()
    zero = torch.tensor(zero_key(run_table.key_dtype), dtype=torch.int64, device=dev)
    frontier = torch.where(valid, evicted.keys, zero).max()
    return evicted, rest, frontier, valid.sum()


def generate_runs_rs(keys, payload, cfg: ExecConfig, *, backend: str = "auto",
                     widths=None, device="cuda"):
    """Replacement-selection run generation with early aggregation (§3.3).

    Returns ``(runs, resident_table_if_no_spill, stats)``.  Runs approach
    2M rows on random input; absorption continues at ~M/O throughout."""
    keys, payload = canon_keys(keys), canon_payload(payload)
    dev = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend, dev)
    width = 0 if payload is None else payload.shape[1]
    return _generate_runs_rs_body(keys, payload, cfg, backend=backend, widths=widths,
                                  width=width, cap=cfg.memory_rows + 2 * cfg.batch_rows,
                                  stats=SpillStats(), runs=[], device=dev)


def _generate_runs_rs_body(keys, payload, cfg, *, backend, widths, width, cap, stats, runs,
                           device):
    M, B = cfg.memory_rows, cfg.batch_rows
    kd = keys.dtype
    run_table = empty_state(cap, width, key_dtype=kd, widths=widths, device=device)
    next_table = empty_state(cap, width, key_dtype=kd, widths=widths, device=device)
    frontier = torch.tensor(zero_key(kd), dtype=torch.int64, device=device)
    open_chunks: list[AggState] = []  # evicted pieces of the open run
    open_len = 0
    occ_r = occ_n = 0

    def close_run():
        nonlocal open_chunks, open_len
        if open_len == 0:
            return
        state = AggState(*(torch.cat([getattr(c, f) for c in open_chunks])
                           for f in ("keys", "count", "sum", "min", "max")), key_dtype=kd)
        runs.append(Run(state=state, length=open_len))
        stats.runs_generated += 1
        open_chunks, open_len = [], 0

    for ck, cp in _np_chunks(keys, payload, B, device):
        batch = sorted_ops.absorb(rows_to_state(ck, cp, key_dtype=kd, widths=run_table.widths),
                                  backend=backend)
        run_table, next_table = rs_split_absorb(run_table, next_table, frontier, batch,
                                                backend=backend)
        occ_r, occ_n = host_ints(run_table.occupancy(), next_table.occupancy())
        while occ_r + occ_n > M:
            if occ_r == 0:
                # the open run is exhausted: close it, promote the next partition
                close_run()
                run_table, next_table = next_table, empty_like(next_table, cap)
                frontier = torch.tensor(zero_key(kd), dtype=torch.int64, device=device)
                occ_r, occ_n = occ_n, 0
                continue
            evicted, run_table, frontier, _ = rs_evict_step(run_table, B)
            n_ev = min(B, occ_r)  # the table is compacted: its valid rows lead
            open_chunks.append(evicted.map(lambda x: x[:n_ev]))
            open_len += n_ev
            stats.rows_spilled_run_generation += n_ev
            occ_r -= n_ev

    if not runs and open_len == 0:
        # everything absorbed in memory: no eviction, so the next-run
        # partition is empty
        return [], run_table, stats
    # drain: finish the open run with the open partition's remainder, then
    # the next-run partition is the last run (both stay sorted throughout)
    if occ_r > 0:
        open_chunks.append(run_table.map(lambda x: x[:occ_r]))
        open_len += occ_r
        stats.rows_spilled_run_generation += occ_r
    close_run()
    if occ_n > 0:
        runs.append(Run(state=next_table.map(lambda x: x[:occ_n + B]), length=occ_n))
        stats.rows_spilled_run_generation += occ_n
        stats.runs_generated += 1
    return runs, None, stats

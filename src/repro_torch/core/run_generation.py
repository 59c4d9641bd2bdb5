"""Replacement-selection steps of run generation (counterpart of the
traceable steps of :mod:`repro.core.run_generation`, §3.3).

Two tables model the partitioned b-tree: the open run's partition holds
keys at or above the eviction frontier, the next run's partition keys
below it.  The host loops (``generate_runs*``) are not ported yet;
the one-shot pipeline (:mod:`repro_torch.core.pipeline`) drives these
steps.
"""
from __future__ import annotations

import torch

from repro_torch.core import sorted_ops
from repro_torch.core.types import AggState, zero_key


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

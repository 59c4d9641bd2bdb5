"""The one-shot external aggregation pipeline on the device (counterpart of
the one-shot part of :mod:`repro.core.pipeline`): run generation under one
of four policies into a stacked run store, the statically planned §4.3
pre-merge levels, then the wide merge (§4).

The policies are the reference's: ``traditional`` and ``inrun_dedup``
write one run per M-row batch (sorted, or sorted and combined),
``early_agg`` absorbs B-row batches into an ordered index of M rows and
writes the whole index when it overflows, ``rs`` is replacement
selection over two partitions (§3.3).

The reference compiles this into one program: a ``lax.scan`` over input
batches whose eviction loop is a data-dependent ``while_loop``.  PyTorch
runs eagerly, so here each flush decision reads occupancies back
(``rs``: the two tables once per trip of its eviction loop; the other
policies once per batch), counted in ``types.SYNCS``, and the run
bookkeeping — run lengths, write cursor, run slot, spill count — stays
in host integers derived from them.  The geometry is the reference's
(pow2-bucketed ``n_pad``, run slots ``R`` of ``C`` rows,
``out_capacity``), so ``SpillStats`` match bit for bit; the trailing
all-EMPTY batches of the pow2 bucket are no-ops and are skipped.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core import merge as merge_mod
from repro_torch.core import run_generation as rg
from repro_torch.core import sorted_ops
from repro_torch.core.types import (
    FIELDS,
    AggState,
    DeviceSpillStats,
    ExchangeOverflowError,
    ExecConfig,
    SpillStats,
    MergeOverflowError,
    StagedChunk,
    StreamEngineState,
    canon_keys,
    canon_payload,
    device_ints,
    empty_key,
    empty_like,
    empty_state,
    host_ints,
    host_list,
    keys_to_torch,
    max_key,
    resolve_device,
    rows_to_state,
    zero_key,
)

POLICIES = ("traditional", "inrun_dedup", "early_agg", "rs")

# what a StreamingAggregator accepts: "adaptive" runs the engine on the
# current arm's own geometry and lets a PolicyGovernor
# (repro_torch.core.adaptive) switch the arm between chunks; a switch
# flushes the tables and reshapes the state to the incoming arm's geometry
# (the run store only ever grows wider: closed runs own their columns)
STREAM_POLICIES = POLICIES + ("adaptive",)

# the arms the governor switches between; inrun_dedup wins neither regime
# (traditional's spill plus a useless combine on unique-heavy input,
# early_agg's persistent window beats its per-batch one on duplicates)
ADAPTIVE_ARMS = ("early_agg", "rs", "traditional")

_log = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_ceil(x: int) -> int:
    return 1 << (x - 1).bit_length() if x > 1 else 1


def _num_batches(n: int, chunk: int) -> int:
    """Batch count bucketed to the next power of two, as in the reference
    (its run-slot bound and output capacity follow from it)."""
    t = (n + chunk - 1) // chunk
    return 1 << (t - 1).bit_length() if t > 1 else t


def _engine_geometry(policy: str, M: int, B: int, P: int):
    """(input chunk rows, run-slot rows, table capacity, second-table
    capacity) of a policy; a table a policy does not use has capacity 0."""
    if policy in ("traditional", "inrun_dedup"):
        return M, _round_up(M, P), 0, 0
    if policy == "early_agg":
        return B, _round_up(M + B, P), M, 0
    if policy == "rs":
        return B, _round_up(2 * M + 2 * B, P), M + 2 * B, M + 2 * B
    raise ValueError(f"unknown run-generation policy {policy!r}")


def _stacked_empty(slots: int, rows: int, width: int, *, key_dtype, widths, device) -> AggState:
    proto = empty_state(rows, width, key_dtype=key_dtype, widths=widths, device=device)
    return proto.map(lambda x: x[None].expand((slots,) + tuple(x.shape)).contiguous())


def _engine_init(policy: str, *, M: int, B: int, P: int, R: int, width: int, key_dtype,
                 widths, device) -> StreamEngineState:
    _, C, capT, capT2 = _engine_geometry(policy, M, B, P)
    return StreamEngineState(
        table=empty_state(capT, width, key_dtype=key_dtype, widths=widths, device=device),
        table2=empty_state(capT2, width, key_dtype=key_dtype, widths=widths, device=device),
        frontier=torch.tensor(zero_key(key_dtype), dtype=torch.int64, device=device),
        store=_stacked_empty(R, C, width, key_dtype=key_dtype, widths=widths, device=device),
        lens=[0] * R,
        cursor=0,
        ridx=0,
        spilled=0,
    )


def _write_slot(store: AggState, slot: int, start: int, state: AggState) -> None:
    """Copy ``state``'s rows into run slot ``slot`` from row ``start``; rows
    past the slot and slots past the store drop, as the reference's
    ``mode="drop"`` scatters do."""
    R, C = store.keys.shape
    if slot >= R:
        return
    rows = min(state.capacity, C - start)
    for f in FIELDS:
        getattr(store, f)[slot, start:start + rows] = getattr(state, f)[:rows]


def _valid_rows(ck: torch.Tensor, key_dtype) -> torch.Tensor:
    """Valid (non-EMPTY) input rows of one batch, a device scalar."""
    return (ck != empty_key(key_dtype)).sum()


def _step_sortwrite(es: StreamEngineState, ck: torch.Tensor, cp, *, dedup: bool,
                    backend: str, ws) -> None:
    """``traditional`` / ``inrun_dedup``: one run per M-row batch, sorted
    (and with ``dedup`` combined), written to the next run slot; a batch
    with no valid row writes nothing.  The duplicates observed are the
    rows that combined (``dedup``) or the adjacent equal keys of the
    sorted batch."""
    kd = es.store.key_dtype
    st = rows_to_state(ck, cp, key_dtype=kd, widths=ws)
    st = (sorted_ops.absorb if dedup else sorted_ops.sort_state)(st, backend=backend)
    if dedup:
        occ, valid = host_ints(st.occupancy(), _valid_rows(ck, kd))
        dups = valid - occ
    else:  # the sort keeps every row; EMPTY sorts last and matches no key
        k = st.keys
        occ, dups = host_ints(st.occupancy(), ((k[1:] == k[:-1]) & (k[1:] != st.empty)).sum())
        valid = occ
    es.absorbed += valid
    es.dups += dups
    if occ == 0:
        return
    _write_slot(es.store, es.ridx, 0, st)
    if es.ridx < es.run_slots:
        es.lens[es.ridx] = occ
    es.ridx += 1
    es.spilled += occ


def _step_early_agg(es: StreamEngineState, ck: torch.Tensor, cp, *, M: int, backend: str,
                    ws) -> None:
    """``early_agg`` (§3): the ordered in-memory index absorbs each sorted,
    deduped batch; when its occupancy passes M the whole index content is
    written to the next run slot and memory restarts empty."""
    kd = es.table.key_dtype
    batch = sorted_ops.absorb(rows_to_state(ck, cp, key_dtype=kd, widths=ws), backend=backend)
    merged = sorted_ops.merge_absorb(es.table, batch, backend=backend,
                                     assume_unique=True)  # capacity M + B
    occ, valid = host_ints(merged.occupancy(), _valid_rows(ck, kd))
    es.absorbed += valid
    es.dups += valid - (occ - es.resident)
    if occ > M:
        _write_slot(es.store, es.ridx, 0, merged)
        if es.ridx < es.run_slots:
            es.lens[es.ridx] = occ
        es.ridx += 1
        es.spilled += occ
        es.table = empty_like(es.table, es.table.capacity)
        es.resident = 0
    else:
        cap = es.table.capacity
        es.table = merged.map(lambda x: x[:cap])
        es.resident = occ


def _step_rs(es: StreamEngineState, ck: torch.Tensor, cp, *, M: int, B: int, backend: str,
             ws) -> None:
    """Replacement selection (§3.3), one input batch: absorb the sorted,
    deduped batch into the two partitions, then evict B-row quanta from the
    open partition (closing the run when it drains or its slot is full)
    until both partitions fit M rows.  Updates ``es`` in place; the
    duplicates observed come with the loop's first readback."""
    C = es.slot_rows
    cap = es.table.capacity
    kd = es.table.key_dtype
    batch = sorted_ops.absorb(rows_to_state(ck, cp, key_dtype=kd, widths=ws), backend=backend)
    es.table, es.table2 = rg.rs_split_absorb(es.table, es.table2, es.frontier, batch,
                                             backend=backend)
    occ_r, occ_n, valid = host_ints(es.table.occupancy(), es.table2.occupancy(),
                                    _valid_rows(ck, kd))
    es.absorbed += valid
    es.dups += valid - (occ_r + occ_n - es.resident)
    while occ_r + occ_n > M:
        if occ_r == 0 or es.cursor + B > C:
            # the open run is exhausted or its slot is full: record it, then
            # merge both partitions into a fresh open partition
            if es.cursor > 0:
                if es.ridx < es.run_slots:
                    es.lens[es.ridx] = es.cursor
                es.ridx += 1
            es.table = sorted_ops.merge_absorb(
                es.table, es.table2, backend=backend, assume_unique=True,
            ).map(lambda x: x[:cap])
            es.table2 = empty_like(es.table2, cap)
            es.frontier = torch.full_like(es.frontier, zero_key(kd))
            es.cursor = 0
        else:
            evicted, es.table, es.frontier, _ = rg.rs_evict_step(es.table, B)
            _write_slot(es.store, es.ridx, es.cursor, evicted)
            n_ev = min(B, occ_r)  # the table is compacted: its valid rows lead
            es.cursor += n_ev
            es.spilled += n_ev
        occ_r, occ_n = host_ints(es.table.occupancy(), es.table2.occupancy())
    es.resident, es.resident2 = occ_r + occ_n, occ_n


def _engine_step(es: StreamEngineState, ck: torch.Tensor, cp, *, policy: str, M: int,
                 B: int, backend: str, ws) -> None:
    """Advance the engine by one input batch."""
    if policy in ("traditional", "inrun_dedup"):
        _step_sortwrite(es, ck, cp, dedup=policy == "inrun_dedup", backend=backend, ws=ws)
    elif policy == "early_agg":
        _step_early_agg(es, ck, cp, M=M, backend=backend, ws=ws)
    else:
        _step_rs(es, ck, cp, M=M, B=B, backend=backend, ws=ws)


def _engine_finish(es: StreamEngineState, *, policy: str):
    """Drain the engine into the run slots.  Returns ``(store, lens,
    table, spilled, nruns, overflow)`` with host ints and lists; the tables'
    occupancies are the host's (``resident``), so the drain reads nothing
    back.

    ``early_agg`` mirrors the resident table into the next slot, so the
    wide merge always sees the whole picture; it counts as a spilled run
    only when earlier runs spilled (the host loop's rule).  ``rs``
    finishes the open run with the open partition's remainder (its own
    slot when there is room, the next one otherwise), then the next-run
    partition becomes the last run.

    The drain writes into ``es.store`` and leaves the tables and the
    counters alone; a snapshot passes a copy of the store, so that the
    live engine stays as it was (:func:`_finalize_stream`)."""
    R, C = es.run_slots, es.slot_rows
    if policy in ("traditional", "inrun_dedup"):
        return es.store, list(es.lens), es.table, es.spilled, es.ridx, es.ridx > R
    if policy == "early_agg":
        occ_t = es.resident
        lens = list(es.lens)
        _write_slot(es.store, es.ridx, 0, es.table)
        if es.ridx < R:
            lens[es.ridx] = occ_t
        spilled = es.spilled + occ_t if es.ridx > 0 else 0
        nruns = es.ridx + (1 if es.ridx > 0 and occ_t > 0 else 0)
        return es.store, lens, es.table, spilled, nruns, es.ridx + 1 > R
    rt, nt = es.table, es.table2
    occ_r, occ_n = es.resident - es.resident2, es.resident2
    cursor, ridx, lens = es.cursor, es.ridx, list(es.lens)
    evicted_any = ridx > 0 or cursor > 0

    def set_len(slot, v):
        if slot < R:
            lens[slot] = v

    if cursor + occ_r <= C:
        _write_slot(es.store, ridx, cursor, rt)
        if cursor + occ_r > 0:
            set_len(ridx, cursor + occ_r)
            ridx += 1
    else:
        set_len(ridx, cursor)
        ridx += 1
        _write_slot(es.store, ridx, 0, rt)
        if occ_r > 0:
            set_len(ridx, occ_r)
            ridx += 1
    _write_slot(es.store, ridx, 0, nt)
    if occ_n > 0:
        set_len(ridx, occ_n)
        ridx += 1
    spilled = es.spilled + occ_r + occ_n if evicted_any else 0
    nruns = ridx if evicted_any else 0
    return es.store, lens, rt, spilled, nruns, ridx > R


def _slots_for(n_pad: int, M: int, extra: int) -> int:
    # every closed run carries > M unique rows, so input over memory bounds
    # the slot count
    return n_pad // (M + 1) + extra


def _stream_run_slots(policy: str, n_pad: int, M: int) -> int:
    """Run-slot bound from the padded row count alone."""
    if policy in ("traditional", "inrun_dedup"):
        return max(1, n_pad // M)  # one run per M-row batch
    if policy == "adaptive":
        # the worst arm mix: traditional's run per M-row batch, plus the rs
        # finish slack; the (< M-row) runs a switch closes are re-anchored
        # into the base slots at the switch
        return max(1, n_pad // M) + 4
    return _slots_for(n_pad, M, 2 if policy == "early_agg" else 4)


def _static_run_slots(policy: str, n: int, M: int, B: int) -> int:
    chunk = _engine_geometry(policy, M, B, 1)[0]
    return _stream_run_slots(policy, _num_batches(n, chunk) * chunk, M)


def _stack(states: list[AggState]) -> AggState:
    return AggState(*(torch.stack([getattr(s, f) for s in states]) for f in FIELDS),
                    key_dtype=states[0].key_dtype)


def _slot(store: AggState, r: int) -> AggState:
    return store.map(lambda x: x[r])


def _pad_store(store: AggState, R_new: int) -> AggState:
    """The run store with empty slots appended up to ``R_new``."""
    R, C = store.keys.shape
    extra = _stacked_empty(R_new - R, C, store.width, key_dtype=store.key_dtype,
                           widths=store.widths, device=store.device)
    return AggState(*(torch.cat([getattr(store, f), getattr(extra, f)]) for f in FIELDS),
                    key_dtype=store.key_dtype)


def _pad_slots(store: AggState, lens: torch.Tensor, R_new: int):
    lens = torch.cat([lens, torch.zeros(R_new - len(lens), dtype=lens.dtype,
                                        device=lens.device)])
    return _pad_store(store, R_new), lens


def _device_premerge(store: AggState, lens: torch.Tensor, *, fanin: int, levels: int,
                     backend: str):
    """§4.3 pre-wide merge levels: each level merges groups of
    ``2^ceil(log2 F)`` run slots as a balanced tree of pairwise
    merge-absorbs (slot count halves, slot capacity doubles).  A group's
    output counts as merge spill only if it combined ≥ 2 live runs."""
    dev = store.device
    spilled = torch.zeros((), dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    nlev = torch.zeros((), dtype=torch.int64, device=dev)
    sub = max(1, (fanin - 1).bit_length())
    G = 1 << sub
    for _ in range(levels):
        R = store.keys.shape[0]
        if R <= 1:
            break
        Rpad = _round_up(R, G)
        if Rpad > R:
            store, lens = _pad_slots(store, lens, Rpad)
        sizes = (lens.reshape(-1, G) > 0).sum(1)
        for _ in range(sub):
            merged = [
                sorted_ops.merge_absorb(_slot(store, r), _slot(store, r + 1), backend=backend)
                for r in range(0, store.keys.shape[0], 2)
            ]
            store = _stack(merged)
            lens = torch.stack([m.occupancy() for m in merged])
        active = sizes >= 2
        spilled = spilled + torch.where(active, lens, 0).sum()
        steps = steps + active.sum()
        nlev = nlev + active.any().to(torch.int64)
    return store, lens, spilled, steps, nlev


def _merge_phase(store: AggState, lens: list[int], spilled: int, nruns: int,
                 overflow: bool, *, page_rows: int, index_rows: int, fanin: int,
                 premerge_levels: int, backend: str, out_capacity: int):
    """Pre-merge levels + the wide merge + the stats.  Without pre-merge
    levels the run lengths stay the host's, and the phase reads nothing
    back; a level's merged lengths are the device's, and the wide merge
    reads its page count back once."""
    if premerge_levels:
        store, lens, spill_m, msteps, mlevels = _device_premerge(
            store, device_ints(lens, store.device), fanin=fanin, levels=premerge_levels,
            backend=backend)
    else:
        spill_m = msteps = mlevels = 0
    out, out_cur, pages_read, max_occ, ix_overflow, dropped = merge_mod.wide_merge_device(
        store, lens, page_rows=page_rows, index_rows=index_rows,
        out_capacity=out_capacity, backend=backend)
    # the in-memory case's pass through the merge is a formality the
    # reference's host loop never pays: charge merge stats only on a spill
    spilled_any = nruns > 0
    one = 1 if spilled_any else 0
    stats = DeviceSpillStats(
        rows_spilled_run_generation=spilled,
        rows_spilled_merge=spill_m,
        runs_generated=nruns,
        merge_steps=msteps + one,
        merge_levels=mlevels + one,
        pages_read=pages_read if spilled_any else 0,
        rows_emitted=out_cur if spilled_any else 0,
        index_overflowed=ix_overflow if spilled_any else False,
        max_index_occupancy=max_occ if spilled_any else 0,
        run_buffer_overflowed=overflow,
        merge_dropped_rows=dropped,
    )
    return out, stats


def _pipeline_body(keys: torch.Tensor, payload, *, key_dtype, policy: str, memory_rows: int,
                   batch_rows: int, page_rows: int, index_rows: int, fanin: int,
                   premerge_levels: int, backend: str, widths, merge: bool = True):
    """Run generation over the batches, then (``merge``) the merge phase:
    ``(out, stats)``; without ``merge``, ``(store, lens, table, stats)``
    after run generation."""
    M, B, P = memory_rows, batch_rows, page_rows
    chunk = _engine_geometry(policy, M, B, P)[0]
    n = keys.shape[0]
    n_pad = _num_batches(n, chunk) * chunk
    t_real = (n + chunk - 1) // chunk  # batches past it are all EMPTY: no-ops
    width = 0 if payload is None else payload.shape[1]
    ws = widths if widths is not None else (width, width, width)
    R = _stream_run_slots(policy, n_pad, M)
    dev = keys.device
    es = _engine_init(policy, M=M, B=B, P=P, R=R, width=width, key_dtype=key_dtype,
                      widths=ws, device=dev)
    padn = t_real * chunk - n
    if padn:
        keys = torch.cat([keys, torch.full((padn,), es.table.empty, dtype=torch.int64,
                                           device=dev)])
        if payload is not None:
            payload = torch.cat([payload, payload.new_zeros((padn, width))])
    for b in range(t_real):
        rows = slice(b * chunk, (b + 1) * chunk)
        _engine_step(es, keys[rows], None if payload is None else payload[rows],
                     policy=policy, M=M, B=B, backend=backend, ws=ws)
    store, lens, table, spilled, nruns, overflow = _engine_finish(es, policy=policy)
    if not merge:
        lens = torch.tensor(lens, dtype=torch.int64, device=dev)
        stats = dataclasses.replace(DeviceSpillStats.zeros(),
                                    rows_spilled_run_generation=spilled,
                                    runs_generated=nruns, run_buffer_overflowed=overflow)
        return store, lens, table, stats
    return _merge_phase(
        store, lens, spilled, nruns, overflow, page_rows=P, index_rows=index_rows,
        fanin=fanin, premerge_levels=premerge_levels, backend=backend,
        out_capacity=max(n_pad, 1),
    )


def _prepare(keys, payload, widths, device, backend):
    """Canonical host input, the device and the concrete backend."""
    dev = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend, dev)
    keys, payload = canon_keys(keys), canon_payload(payload)
    if payload is None:
        widths = (0, 0, 0) if widths is None else widths
    return keys, payload, widths, dev, backend


def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")


def generate_runs_device(keys, payload=None, cfg: ExecConfig | None = None, *,
                         policy: str = "early_agg", backend: str = "auto", widths=None,
                         device="cuda"):
    """Run generation alone on the device.  Returns ``(store, lens, table,
    dstats)``: the stacked run store (fields ``(R, C, ...)``), the run
    lengths (an int64 tensor), the resident table and the run-generation
    :class:`DeviceSpillStats`.  The host loop with the same semantics is
    :func:`repro_torch.core.run_generation.generate_runs`."""
    cfg = cfg or ExecConfig()
    _check_policy(policy)
    keys, payload, widths, dev, backend = _prepare(keys, payload, widths, device, backend)
    pt = None if payload is None else torch.from_numpy(payload).to(dev)
    return _pipeline_body(
        keys_to_torch(keys, dev), pt, key_dtype=keys.dtype, policy=policy,
        memory_rows=cfg.memory_rows, batch_rows=cfg.batch_rows, page_rows=cfg.page_rows,
        index_rows=cfg.memory_rows, fanin=cfg.fanin, premerge_levels=0, backend=backend,
        widths=widths, merge=False,
    )


def _mesh_pad(keys: np.ndarray, payload, n_loc: int):
    """EMPTY/zero-pad a rank's host rows to the mesh's ``n_loc`` (the
    reference pads the global input to ``world·n_loc`` rows, so the last
    shards carry the EMPTY rows)."""
    short = n_loc - keys.shape[0]
    if short <= 0:
        return keys, payload
    keys = np.concatenate([keys, np.full(short, np.iinfo(keys.dtype).max, keys.dtype)])
    if payload is not None:
        payload = np.concatenate([payload, np.zeros((short,) + payload.shape[1:],
                                                    payload.dtype)])
    return keys, payload


def _mesh_exchange(out: AggState, dstats: DeviceSpillStats, mesh, *, backend: str,
                   quota: int | None, page_rows: int):
    """The mesh tail of every pipeline: the key-range exchange and the
    per-owner merge of a rank's merge output, its accounting into the
    stats, and the stats reduced over the ranks (no readback)."""
    from repro_torch.distributed import groupby as gb_mod  # lazy: gb imports core

    merged, ex = gb_mod.exchange_and_merge(out, mesh, backend=backend, quota=quota,
                                           page_rows=page_rows)
    dstats = dataclasses.replace(
        dstats, merge_dropped_rows=torch.as_tensor(dstats.merge_dropped_rows,
                                                   device=out.device) | ex.merge_dropped,
        rows_exchanged=ex.rows_sent, exchange_dropped=ex.send_dropped,
        exchange_quota=ex.quota, exchange_max_fill=ex.max_fill, exchange_capacity=ex.capacity)
    return merged, dstats.cross_shard(mesh)


def _mesh_rows(keys: np.ndarray, mesh) -> int:
    """The rows every rank runs over: the most any rank was given (one
    collective of a host int), so that every rank plans the same geometry
    and exchange quota."""
    from repro_torch.distributed import sharding  # lazy: sharding imports core

    return sharding.host_all_reduce(mesh, [keys.shape[0]], "max")[0]


def aggregate_device(keys, payload=None, cfg: ExecConfig | None = None, *,
                     policy: str = "rs", backend: str = "auto", widths=None,
                     output_estimate: int | None = None, mesh=None,
                     mesh_axis: str | None = None, exchange_quota: int | None = None,
                     device="cuda") -> tuple[AggState, DeviceSpillStats]:
    """Run generation + pre-merge levels + wide merge over host input
    (``keys`` uint32/uint64, ``payload`` (N, V) float) on ``device``.
    Output is key-sorted, duplicate-free, EMPTY-padded to the batched input
    capacity; ``output_estimate`` fixes the number of pre-merge levels and
    never changes the answer.

    ``mesh`` (a :class:`repro_torch.distributed.sharding.Mesh`) shards the
    pipeline: every rank calls this with its own rows (for the reference's
    sharding of a global input, :func:`~repro_torch.distributed.sharding.
    local_slice`; ranks given fewer rows than the most pad with EMPTY),
    runs run generation, the pre-merge levels (planned from its own
    ``n_loc``) and the wide merge over them, then a sampled key-range
    ``all_to_all`` exchanges the sorted, duplicate-free outputs at a
    capacity-bounded per-peer quota (``exchange_quota`` overrides it) and
    each range owner streams its fragments through the wide merge.  The
    rank's result is its key range, sorted and EMPTY-padded; the ranks'
    results are sorted by rank.  The stats are reduced over the ranks
    (:meth:`DeviceSpillStats.cross_shard`), the same on every rank."""
    cfg = cfg or ExecConfig()
    _check_policy(policy)
    keys, payload, widths, dev, backend = _prepare(keys, payload, widths, device, backend)
    if mesh is not None:
        from repro_torch.distributed import sharding

        sharding.resolve_mesh_axis(mesh, mesh_axis)
        sharding.check_mesh_device(mesh, dev)
        n_loc = _mesh_rows(keys, mesh)
        keys, payload = _mesh_pad(keys, payload, n_loc)
    if keys.shape[0] == 0:
        width = 0 if payload is None else payload.shape[1]
        return (empty_state(0, width, key_dtype=keys.dtype, widths=widths, device=dev),
                DeviceSpillStats.zeros())
    from repro_torch.core.insort import plan_pre_merge_levels  # lazy: avoids a cycle

    est = cfg.memory_rows * cfg.fanin if output_estimate is None else output_estimate
    # the §4.3 plan is a rank's: from its static run-slot bound over its rows
    r_static = _static_run_slots(policy, keys.shape[0], cfg.memory_rows, cfg.batch_rows)
    pre = plan_pre_merge_levels(est, cfg, r_static)
    pt = None if payload is None else torch.from_numpy(payload).to(dev)
    out, dstats = _pipeline_body(
        keys_to_torch(keys, dev), pt, key_dtype=keys.dtype, policy=policy,
        memory_rows=cfg.memory_rows, batch_rows=cfg.batch_rows, page_rows=cfg.page_rows,
        index_rows=cfg.memory_rows, fanin=cfg.fanin, premerge_levels=pre,
        backend=backend, widths=widths,
    )
    if mesh is None:
        return out, dstats
    return _mesh_exchange(out, dstats, mesh, backend=backend, quota=exchange_quota,
                          page_rows=cfg.page_rows)


def insort_aggregate_device(keys, payload=None, cfg: ExecConfig | None = None, *,
                            policy: str = "rs", backend: str = "auto", widths=None,
                            output_estimate: int | None = None, mesh=None,
                            mesh_axis: str | None = None, exchange_quota: int | None = None,
                            device="cuda") -> tuple[AggState, SpillStats]:
    """:func:`aggregate_device` + the readback of the spill stats.

    On a mesh, an exchange whose quota proved too small for the data's
    skew retries once at the next pow2 quota (capped at the lossless
    per-rank capacity) with a warning: the stats' readback, replicated on
    every rank, is the decision point, so every rank retries together.  A
    second overflow raises :class:`ExchangeOverflowError`."""
    kw = dict(policy=policy, backend=backend, widths=widths, output_estimate=output_estimate,
              mesh=mesh, mesh_axis=mesh_axis, device=device)
    state, dstats = aggregate_device(keys, payload, cfg, exchange_quota=exchange_quota, **kw)
    try:
        return state, dstats.finalize()
    except ExchangeOverflowError as e:
        if mesh is None:
            raise  # impossible without an exchange; do not mask a bug
        from repro_torch.distributed import groupby as gb_mod  # lazy: gb imports core

        quota2 = gb_mod.next_exchange_quota(e.quota, e.capacity)
        if quota2 is None:
            raise  # already at the lossless ceiling: a retry cannot help
        _log.warning("mesh exchange overflowed its per-peer quota=%d (fullest segment %d "
                     "rows); retrying once at quota=%d", e.quota, e.max_fill, quota2)
        state, dstats = aggregate_device(keys, payload, cfg, exchange_quota=quota2, **kw)
        return state, dataclasses.replace(dstats.finalize(), exchange_retries=1)


# ---------------------------------------------------------------------------
# the streamed pipeline: the same engine fed chunk by chunk
# ---------------------------------------------------------------------------
#
# The reference jits these pieces over a donated engine state and carries a
# local window of the run store for XLA's sake; here they are plain
# functions that update the port's state in place, and the run bookkeeping
# stays on the host.


def _trim_slots(es: StreamEngineState, trim: int) -> StreamEngineState:
    """The engine with only its first ``trim`` run slots (a view of the
    store).  The pow2 growth schedule overshoots; by finalize the runs can
    only occupy the exact bound's slots, and merging the empty overshoot
    would cost real merge work."""
    if trim >= es.run_slots:
        return es
    return dataclasses.replace(es, store=es.store.map(lambda x: x[:trim]), lens=es.lens[:trim])


def _finalize_stream(es: StreamEngineState, retired: int, *, policy: str, page_rows: int,
                     index_rows: int, fanin: int, premerge_levels: int, backend: str,
                     out_capacity: int, trim: int, copy_store: bool):
    """Drain + pre-merge + wide merge of a stream's engine.  The drain
    writes the resident tables into run slots; ``copy_store`` (a snapshot)
    drains into a copy of the store, so that the live engine stays byte for
    byte as it was and ingest can continue.  ``retired`` is the rows
    eviction took out of the engine."""
    es = _trim_slots(es, trim)
    if copy_store and policy in ("early_agg", "rs"):  # the policies whose drain writes
        es = dataclasses.replace(es, store=es.store.map(torch.clone))
    store, lens, _, spilled, nruns, overflow = _engine_finish(es, policy=policy)
    out, stats = _merge_phase(
        store, lens, spilled, nruns, overflow, page_rows=page_rows, index_rows=index_rows,
        fanin=fanin, premerge_levels=premerge_levels, backend=backend,
        out_capacity=out_capacity)
    return out, dataclasses.replace(stats, rows_retired=retired)


def _retire_sorted_prefix(planes: AggState, cut: torch.Tensor, valid: torch.Tensor) -> AggState:
    """Shift every slot's rows (fields ``(R, C[, w])``) left by its prefix
    ``cut`` and refill past the surviving ``valid - cut`` rows as
    :func:`empty_state` does, so that a slot retired whole equals a fresh
    one."""
    C = planes.keys.shape[1]
    ar = torch.arange(C, device=planes.device)
    idx = (ar[None, :] + cut[:, None]).clamp(max=max(C - 1, 0))
    live = ar[None, :] < (valid - cut)[:, None]

    def shift(a, fill):
        if a.numel() == 0:
            return a
        if a.dim() == 2:
            return torch.where(live, torch.gather(a, 1, idx), fill)
        g = torch.gather(a, 1, idx[:, :, None].expand(-1, -1, a.shape[2]))
        return torch.where(live[:, :, None], g, fill)

    inf = float("inf")
    return AggState(shift(planes.keys, planes.empty), shift(planes.count, 0),
                    shift(planes.sum, 0.0), shift(planes.min, inf), shift(planes.max, -inf),
                    planes.key_dtype)


def _evict_compact(es: StreamEngineState, threshold: int) -> int:
    """Retire every resident row with key < ``threshold`` (the port's int64
    key) from the engine, in place, and compact the surviving runs to the
    front of the store.  Every part of the engine keeps its rows sorted with
    an EMPTY tail (closed runs, the open rs run's ``[0, cursor)`` prefix,
    the tables), so retirement is a prefix cut per slot.  Surviving closed
    runs keep their order, then the open slot, then the emptied slots.  One
    readback (the cuts and the tables' occupancies).  Returns the rows
    retired."""
    R = es.run_slots
    dev = es.store.device
    tables = [name for name in ("table", "table2") if getattr(es, name).capacity]
    thr = torch.full((R, 1), threshold, dtype=torch.int64, device=dev)
    parts = [torch.searchsorted(es.store.keys, thr).reshape(R)]
    for name in tables:
        t = getattr(es, name)
        parts += [torch.searchsorted(t.keys, thr[0]), t.occupancy().reshape(1)]
    vec = host_list(torch.cat(parts))
    # per slot the valid rows: closed slots carry lens, the rs open slot's
    # prefix is the cursor (its lens is set when the run closes)
    valid = [max(n, es.cursor if r == es.ridx else 0) for r, n in enumerate(es.lens)]
    cut = [min(c, v) for c, v in zip(vec[:R], valid)]
    store = _retire_sorted_prefix(es.store, torch.tensor(cut, device=dev),
                                  torch.tensor(valid, device=dev))
    lens = [n - min(c, n) for n, c in zip(es.lens, cut)]
    if 0 <= es.ridx < R:
        es.cursor -= cut[es.ridx]
    perm = sorted(range(R), key=lambda r: 0 if lens[r] > 0 else 1 if r == es.ridx else 2)
    es.store = store.map(lambda x: x.index_select(0, torch.tensor(perm, device=dev)))
    es.lens = [lens[r] for r in perm]
    es.ridx = sum(n > 0 for n in es.lens)
    retired = sum(cut)
    for i, name in enumerate(tables):
        t = getattr(es, name)
        cut_t, occ = vec[R + 2 * i], vec[R + 2 * i + 1]
        cut_t = min(cut_t, occ)
        lifted = _retire_sorted_prefix(t.map(lambda x: x[None]), torch.tensor([cut_t], device=dev),
                                       torch.tensor([occ], device=dev))
        setattr(es, name, lifted.map(lambda x: x[0]))
        es.resident -= cut_t
        if name == "table2":
            es.resident2 -= cut_t
        retired += cut_t
    return retired


def _switch_flush(es: StreamEngineState, *, policy: str, backend: str) -> None:
    """Close out the current arm so that the next chunk can run under
    another: close the open rs run, then write the resident table as one
    closed sorted run and reset the tables, frontier and cursor.  After it
    every arm sees what it would after its own init (empty tables, closed
    sorted runs in the store), and the finalize merge takes any mix of
    runs.  The table's occupancy is read back once."""
    R, kd = es.run_slots, es.key_dtype
    if policy == "rs":
        if es.cursor > 0:
            if es.ridx < R:
                es.lens[es.ridx] = es.cursor
            es.ridx += 1
        cap = es.table.capacity
        es.table = sorted_ops.merge_absorb(es.table, es.table2, backend=backend,
                                           assume_unique=True).map(lambda x: x[:cap])
        es.table2 = empty_like(es.table2, es.table2.capacity)
        es.frontier = torch.full_like(es.frontier, zero_key(kd))
        es.cursor = 0
    if es.table.capacity:
        (occ,) = host_ints(es.table.occupancy())
        if occ > 0:
            _write_slot(es.store, es.ridx, 0, es.table)
            if es.ridx < R:
                es.lens[es.ridx] = occ
            es.ridx += 1
            es.spilled += occ
        es.table = empty_like(es.table, es.table.capacity)
    es.resident = es.resident2 = 0


def _switch_reshape(es: StreamEngineState, *, slot_rows: int, capT: int, capT2: int,
                    width: int, widths) -> None:
    """Reshape a just-flushed engine to the incoming arm's geometry: the
    (empty) tables re-allocated at the new capacities, the run store copied
    into a wider empty one when the arm's slots are wider (each slot's rows
    stay left-packed with EMPTY tails; the store never narrows)."""
    kd, dev = es.key_dtype, es.store.device
    if slot_rows != es.slot_rows:
        store = _stacked_empty(es.run_slots, slot_rows, width, key_dtype=kd, widths=widths,
                               device=dev)
        for f in FIELDS:
            getattr(store, f)[:, :es.slot_rows] = getattr(es.store, f)
        es.store = store
    es.table = empty_state(capT, width, key_dtype=kd, widths=widths, device=dev)
    es.table2 = empty_state(capT2, width, key_dtype=kd, widths=widths, device=dev)


class _Stager:
    """Host→device copies of a stream's chunks on a side CUDA stream, from
    two pinned host buffers used in turn, so that chunk k+1 is copied while
    the compute stream absorbs chunk k.  A buffer is refilled only after
    its last copy's event has completed.  The device tensors are allocated
    under the side stream and marked with ``record_stream`` for the compute
    stream, so that the caching allocator cannot hand their memory out
    while the engine still reads them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers: list = [None, None]  # (pinned keys, pinned payload, event)
        self.turn = 0

    def put(self, keys: torch.Tensor, payload: torch.Tensor, rows: int, rows_padded: int,
            local_rows: int) -> StagedChunk:
        i, self.turn = self.turn, self.turn ^ 1
        n, w = payload.shape
        buf = self.buffers[i]
        if buf is not None:
            buf[2].synchronize()  # the last copy out of this buffer is done
        if buf is None or buf[0].shape[0] < n or buf[1].shape[1] != w:
            buf = (torch.empty(n, dtype=torch.int64, pin_memory=True),
                   torch.empty((n, w), dtype=torch.float32, pin_memory=w > 0), None)
        pk, pp = buf[0][:n], buf[1][:n]
        pk.copy_(keys)
        pp.copy_(payload)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            dk = pk.to(self.device, non_blocking=True)
            dp = pp.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        dk.record_stream(compute)
        dp.record_stream(compute)
        self.buffers[i] = (buf[0], buf[1], event)
        return StagedChunk(keys=dk, payload=dp, rows=rows, rows_padded=rows_padded,
                           local_rows=local_rows, event=event)


class StreamingAggregator:
    """Feed the external aggregation engine chunk by chunk from the host
    (counterpart of :class:`repro.core.pipeline.StreamingAggregator`).

    The engine state stays on the device between chunks; the run
    bookkeeping stays on the host, where the engine's readbacks put it.
    The protocol, as the reference's::

        agg = StreamingAggregator(cfg, policy="rs", key_dtype=np.uint32, width=V,
                                  device="cuda")
        staged = agg.stage(keys0, pay0)     # the copy of chunk 0 starts
        for keys, pay in chunks:
            nxt = agg.stage(keys, pay)      # the copy of chunk k+1 runs while …
            agg.absorb_staged(staged)       # … the card absorbs chunk k
            staged = nxt
        agg.absorb_staged(staged)
        state, stats = agg.finalize()

    The run store is sized on the host from the cumulative padded row count
    (every flushed run holds more than M rows, so input over memory bounds
    the slots) and grows in pow2 slot counts, as the reference's does, so
    that overflow and retries behave the same.

    ``policy="adaptive"`` keeps the engine at the current arm's own
    geometry and lets a :class:`repro_torch.core.adaptive.PolicyGovernor`
    pick the arm (``early_agg``, ``rs``, ``traditional``) from the observed
    duplicate rate every ``k``-th chunk.  The governor decides on the
    observation taken at the previous boundary, as the reference's does
    (its readback is pipelined one interval behind); only a switch takes a
    fresh one.  ``readbacks_paid`` counts those observations as the
    reference counts its readbacks (the port's counters are host ints, so
    they cost no device sync here); the port's own syncs stay in
    ``types.SYNCS``.  Adaptive streams need ``memory_rows % batch_rows ==
    0``.  ``snapshot``/``evict_below`` are the service's protocol: a
    merge-on-read answer that leaves the engine as it was, and the
    retirement of expired key ranges.

    ``device`` defaults to ``"cuda"`` and raises without a card; on a card
    the kernels launch or the call raises.

    ``mesh`` (a :class:`repro_torch.distributed.sharding.Mesh`) shards the
    stream as the reference's ``device_put(NamedSharding(P(axis)))`` does:
    every rank stages the same global chunks, pads each to ``world·t``
    batches (``t`` the pow2 bucket of ``ceil(n / world)`` rows' batches)
    and keeps batches ``[rank·t, (rank+1)·t)``; each rank's engine absorbs
    its slice, the slot bound is the rank's (``rows_padded // world``), and
    finalize and snapshot end with the key-range exchange and per-owner
    merge of the one-shot mesh pipeline (a snapshot on its copy of the run
    store, so the live engine stays as it was), its stats reduced over the
    ranks.  Every rank must make every call.  ``policy="adaptive"`` and
    ``governor=`` do not compose with a mesh and raise, as in the
    reference."""

    def __init__(self, cfg: ExecConfig | None = None, *, policy: str = "rs",
                 key_dtype=np.uint32, width: int = 0, widths=None, backend: str = "auto",
                 index_rows: int | None = None, output_estimate: int | None = None,
                 output_rows: int | None = None, mesh=None, mesh_axis: str | None = None,
                 governor=None, device="cuda"):
        cfg = cfg or ExecConfig()
        if policy not in STREAM_POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of {STREAM_POLICIES}")
        self.cfg = cfg
        self.policy = policy
        self.device = resolve_device(device)
        self.mesh = mesh
        self.world = 1
        if mesh is not None:
            from repro_torch.distributed import sharding  # lazy: sharding imports core

            sharding.resolve_mesh_axis(mesh, mesh_axis)
            sharding.check_mesh_device(mesh, self.device)
            self.world = mesh.world
        elif mesh_axis is not None:
            raise ValueError("mesh_axis= was passed without mesh=")
        self.backend = dispatch.resolve_backend_name(backend, self.device)
        self.key_dtype = np.dtype(key_dtype)
        if self.key_dtype not in (np.dtype(np.uint32), np.dtype(np.uint64)):
            raise TypeError(f"key_dtype must be uint32 or uint64, got {self.key_dtype}")
        self.width = int(width)
        self.widths = tuple(widths) if widths is not None else (self.width,) * 3
        self.index_rows = index_rows or cfg.memory_rows
        self.output_estimate = output_estimate
        self.output_rows = output_rows
        # the staging unit: adaptive streams stage M-row units and cut them
        # to the current arm's batch at absorb time (B divides M)
        self._chunk = (cfg.memory_rows if policy == "adaptive" else _engine_geometry(
            policy, cfg.memory_rows, cfg.batch_rows, cfg.page_rows)[0])
        self._stager = _Stager(self.device) if self.device.type == "cuda" else None
        self._es: StreamEngineState | None = None
        self._R = 0  # run slots allocated
        self._finalized = False
        self.rows_seen = 0
        self.rows_padded = 0  # cumulative rows of the chunks' padded geometry
        # the service's protocol: rows retired so far (None until the first
        # eviction) and the slot-accounting baseline of the last eviction
        self._retired: int | None = None
        self._base_slots = 0
        self._rows_since_evict = 0
        # adaptive streams: the arm the next absorb uses, the governor, and
        # the observation and switch accounting
        self.policy_events: list[dict] = []
        self.readbacks_paid = 0
        self._chunks_absorbed = 0
        self._last_dup_rate = 0.0
        self._pending_obs = None  # the boundary observation awaiting harvest
        self._last_obs_vec = None  # the newest boundary's observation
        if policy == "adaptive":
            if mesh is not None:
                raise ValueError("policy='adaptive' does not compose with mesh= yet — pick a "
                                 "fixed policy for sharded streams")
            if cfg.memory_rows % cfg.batch_rows:
                raise ValueError(
                    "policy='adaptive' needs memory_rows divisible by batch_rows (chunks "
                    "are staged at unit-M granularity and re-shaped per arm), got "
                    f"M={cfg.memory_rows} B={cfg.batch_rows}")
            from repro_torch.core import adaptive as adaptive_mod

            if isinstance(governor, adaptive_mod.PolicyGovernor):
                self._governor = governor
            else:
                if governor is None:  # the constants of this device type
                    governor = adaptive_mod.GovernorConfig(backend=self.device.type)
                self._governor = adaptive_mod.PolicyGovernor(cfg, config=governor)
            self._arm = self._governor.start_arm(output_estimate=output_estimate)
        else:
            if governor is not None and mesh is not None:
                raise ValueError(
                    "governor= was passed on a mesh= stream, but the adaptive governor does "
                    "not compose with mesh= yet (it needs a cross-shard observation reduce). "
                    f"It would have silently run the fixed policy {policy!r}; pick a fixed "
                    "policy and drop governor=, or run unsharded with policy='adaptive'")
            if governor is not None:
                raise ValueError(
                    f"governor= was passed with fixed policy {policy!r}; it would have been "
                    "silently ignored — use policy='adaptive' to let the governor steer, or "
                    "drop governor=")
            self._governor = None
            self._arm = policy

    # -- staging ---------------------------------------------------------

    def _prep(self, keys, payload):
        """Canonical host keys and payload, EMPTY-padded to whole staging
        units (in the unsigned domain: the dtype's all-ones).  Returns
        ``(keys, payload, rows, rows_padded, local_rows)``; ``rows_padded``
        is the reference's pow2-bucketed batch geometry, which sizes the
        slots.  On a mesh the keys and payload are this rank's slice of the
        chunk padded to ``world·t`` batches, and ``local_rows`` its valid
        rows."""
        keys = canon_keys(keys)
        if keys.dtype != self.key_dtype:
            raise TypeError(f"chunk key dtype {keys.dtype} != aggregator key_dtype "
                            f"{self.key_dtype}")
        n = keys.shape[0]
        if payload is None:
            payload = np.zeros((n, self.width), np.float32)
        else:
            payload = np.asarray(payload, dtype=np.float32)
            if payload.ndim == 1:
                payload = payload[:, None]
        if payload.shape != (n, self.width):
            raise ValueError(f"chunk payload shape {payload.shape} != ({n}, "
                             f"width={self.width})")
        local = n
        n_pad = _num_batches(n, self._chunk) * self._chunk
        if self.mesh is not None:
            span = _num_batches(-(-n // self.world), self._chunk) * self._chunk
            n_pad = self.world * span
            r0 = self.mesh.rank * span
            keys, payload = keys[r0:r0 + span], payload[r0:r0 + span]
            local = keys.shape[0]
        n_stage = -(-local // self._chunk) * self._chunk
        if n_stage > local:
            keys = np.concatenate([keys, np.full(n_stage - local, np.iinfo(keys.dtype).max,
                                                 keys.dtype)])
            payload = np.concatenate([payload, np.zeros((n_stage - local, self.width),
                                                        np.float32)])
        return keys, payload, n, n_pad, local

    def stage(self, keys, payload=None) -> StagedChunk | None:
        """Start the host→device copy of one chunk (a plain conversion on
        the CPU).  Returns a :class:`StagedChunk` for :meth:`absorb_staged`;
        staging chunk k+1 before absorbing chunk k hides the copy behind the
        absorb.  Empty chunks return None."""
        if np.asarray(keys).shape[0] == 0:
            return None
        keys, payload, n, n_pad, local = self._prep(keys, payload)
        kt, pt = keys_to_torch(keys, "cpu"), torch.from_numpy(np.ascontiguousarray(payload))
        if self._stager is None:
            return StagedChunk(keys=kt.to(self.device), payload=pt.to(self.device), rows=n,
                               rows_padded=n_pad, local_rows=local)
        return self._stager.put(kt, pt, n, n_pad, local)

    # -- absorbing -------------------------------------------------------

    def _bound(self, rows_padded: int) -> int:
        return _stream_run_slots(self.policy, rows_padded // self.world, self.cfg.memory_rows)

    def _local_slots(self, chunk_padded: int) -> int:
        """Run slots one chunk can reach: its own bound and the open slot,
        for the current arm of an adaptive stream."""
        return _stream_run_slots(self._arm, chunk_padded // self.world,
                                 self.cfg.memory_rows) + 1

    def _bound_total(self, rows_since_baseline: int) -> int:
        """Slot bound from the eviction or switch baseline: the live runs
        then (``_base_slots``, with the finish slack) plus the bound of the
        rows absorbed since."""
        return self._base_slots + self._bound(rows_since_baseline)

    def _slots_needed(self, rows_padded_total: int, chunk_padded: int) -> int:
        prev = rows_padded_total - chunk_padded
        return _pow2_ceil(max(self._bound_total(rows_padded_total),
                              self._bound_total(prev) + self._local_slots(chunk_padded)))

    def absorb_staged(self, staged: StagedChunk | None) -> None:
        """Absorb a staged chunk: the engine steps over its batches (the
        current arm's batch size; the all-EMPTY batches of the chunk's pow2
        bucket are no-ops and are skipped)."""
        if staged is None:
            return
        if self._finalized:
            raise RuntimeError("StreamingAggregator already finalized")
        cfg = self.cfg
        needed = self._slots_needed(self._rows_since_evict + staged.rows_padded,
                                    staged.rows_padded)
        if self._es is None:  # adaptive: at the start arm's geometry
            self._R = needed
            self._es = _engine_init(self._arm, M=cfg.memory_rows, B=cfg.batch_rows,
                                    P=cfg.page_rows, R=needed, width=self.width,
                                    key_dtype=self.key_dtype, widths=self.widths,
                                    device=self.device)
        elif needed > self._R:
            self._es.store = _pad_store(self._es.store, needed)
            self._es.lens += [0] * (needed - self._R)
            self._R = needed
        if staged.event is not None:
            torch.cuda.current_stream(self.device).wait_event(staged.event)
        chunk = _engine_geometry(self._arm, cfg.memory_rows, cfg.batch_rows, cfg.page_rows)[0]
        for b in range(-(-staged.local_rows // chunk)):
            rows = slice(b * chunk, (b + 1) * chunk)
            _engine_step(self._es, staged.keys[rows], staged.payload[rows], policy=self._arm,
                         M=cfg.memory_rows, B=cfg.batch_rows, backend=self.backend,
                         ws=self.widths)
        self.rows_seen += staged.rows
        self.rows_padded += staged.rows_padded
        self._rows_since_evict += staged.rows_padded
        self._chunks_absorbed += 1
        if self._governor is not None and self._chunks_absorbed % self._governor.interval == 0:
            self._last_obs_vec = self._observation()
            self._maybe_adapt()

    def absorb(self, keys, payload=None) -> None:
        """stage + absorb in one call (no overlap)."""
        self.absorb_staged(self.stage(keys, payload))

    # -- adaptive policy switching ----------------------------------------

    @property
    def arm(self) -> str:
        """The run-generation policy the next absorb uses (``policy`` for
        fixed-policy streams)."""
        return self._arm

    def _observation(self) -> tuple[int, int, int, int, int]:
        es = self._es
        return es.absorbed, es.dups, es.spilled, es.resident, es.ridx

    def observe(self):
        """The engine's decision scalars as a
        :class:`repro_torch.core.adaptive.Observation`, counted in
        ``readbacks_paid``."""
        from repro_torch.core import adaptive as adaptive_mod

        if self._es is None:
            return adaptive_mod.Observation(0, 0, 0, 0, 0)
        self.readbacks_paid += 1
        return adaptive_mod.Observation(*self._observation())

    def _maybe_adapt(self) -> None:
        """Governor boundary: decide on the observation the previous
        boundary took, keep this boundary's for the next; a switch takes a
        fresh observation (its slot re-anchor needs the current high-water
        mark)."""
        from repro_torch.core import adaptive as adaptive_mod

        pending = self._pending_obs
        self._pending_obs = self._last_obs_vec
        if pending is None:
            return  # first boundary: the observation pipeline is priming
        self.readbacks_paid += 1
        obs = adaptive_mod.Observation(*pending)
        self._last_dup_rate = obs.duplicate_rate
        nxt = self._governor.decide(obs, current=self._arm)
        if nxt != self._arm:
            obs_now = self.observe()
            self._last_dup_rate = obs_now.duplicate_rate
            self._switch_arm(nxt, obs_now)

    def _switch_arm(self, to: str, obs) -> None:
        """Move the engine to arm ``to``: flush (:func:`_switch_flush`),
        reshape to ``to``'s geometry where it differs
        (:func:`_switch_reshape`), and re-anchor the slot accounting at the
        observed high-water mark (the flushed runs can hold fewer than M
        rows, so input over memory alone no longer bounds the slots)."""
        cfg = self.cfg
        _switch_flush(self._es, policy=self._arm, backend=self.backend)
        _, C_to, capT_to, capT2_to = _engine_geometry(to, cfg.memory_rows, cfg.batch_rows,
                                                      cfg.page_rows)
        C_new = max(C_to, self._es.slot_rows)
        if (C_new != self._es.slot_rows or capT_to != self._es.table.capacity
                or capT2_to != self._es.table2.capacity):
            _switch_reshape(self._es, slot_rows=C_new, capT=capT_to, capT2=capT2_to,
                            width=self.width, widths=self.widths)
        self.policy_events.append({"rows_seen": self.rows_seen, "from": self._arm, "to": to,
                                   "duplicate_rate": round(obs.duplicate_rate, 4)})
        self._arm = to
        self._base_slots = int(obs.run_slots_used) + 2 + 4  # + ≤ 2 flushed runs + rs slack
        self._rows_since_evict = 0
        self._pending_obs = None  # observed before the flush: stale
        self._last_obs_vec = None

    def _patch_stats(self, stats: SpillStats) -> SpillStats:
        """The adaptive observation block on the host stats; fixed-policy
        streams that never observed return ``stats`` unchanged."""
        if self._governor is None and not self.readbacks_paid:
            return stats
        return dataclasses.replace(stats, duplicate_rate=self._last_dup_rate,
                                   policy_switches=len(self.policy_events),
                                   readbacks_paid=self.readbacks_paid)

    def wait(self) -> None:
        """Block until the card has finished the work queued so far (phase
        boundaries of a measurement; never needed for correctness)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- finalizing ------------------------------------------------------

    def _empty_result(self):
        return (empty_state(0, self.width, key_dtype=self.key_dtype, widths=self.widths,
                            device=self.device), DeviceSpillStats.zeros())

    def finalize_device(self) -> tuple[AggState, DeviceSpillStats]:
        """Drain + pre-merge + wide merge; the stats before their readback.
        Consumes the engine."""
        if self._finalized:
            raise RuntimeError("StreamingAggregator already finalized")
        self._finalized = True
        if self._es is None:  # nothing absorbed: empty result
            return self._empty_result()
        pre, out_cap, trim = self._merge_plan(bucketed=False)
        es, self._es = self._es, None
        return self._run_merge(es, pre, out_cap, trim)

    def _retry_exchange(self, entry_point: str, err: ExchangeOverflowError, es, pre: int,
                        out_cap: int, trim: int, copy_store: bool):
        """The mesh exchange's quota was too small for the data's skew: run
        the merge and the exchange once more at the next pow2 quota, capped
        at the lossless per-rank output capacity.  A second overflow
        raises."""
        from repro_torch.distributed import groupby as gb_mod  # lazy: gb imports core

        quota2 = gb_mod.next_exchange_quota(err.quota, out_cap)
        if quota2 is None:
            raise err  # already at the lossless ceiling
        _log.warning("%s exchange overflowed its per-peer quota=%d (fullest segment %d rows); "
                     "retrying once at quota=%d", entry_point, err.quota, err.max_fill, quota2)
        state, dstats = self._run_merge(es, pre, out_cap, trim, copy_store=copy_store,
                                        exchange_quota=quota2)
        stats = dstats.finalize(entry_point=entry_point)
        return state, dataclasses.replace(stats, exchange_retries=stats.exchange_retries + 1)

    def _retry_capacity(self, entry_point: str, err: Exception, es, pre: int, out_cap: int,
                        trim: int, copy_store: bool):
        """The wide merge dropped rows: run the merge ONCE more at the next
        pow2 output capacity with one more pre-merge level.  A second
        overflow raises."""
        out_cap2 = _pow2_ceil(out_cap + 1)
        _log.warning("%s overflowed its out_capacity=%d (%s); retrying once at "
                     "out_capacity=%d with %d pre-merge levels", entry_point, out_cap, err,
                     out_cap2, pre + 1)
        state, dstats = self._run_merge(es, pre + 1, out_cap2, trim, copy_store=copy_store)
        return state, dstats.finalize(entry_point=entry_point)

    def finalize(self) -> tuple[AggState, SpillStats]:
        """:meth:`finalize_device` + the stats' readback; a merge-output
        overflow is retried once at the next pow2 before raising."""
        if self._finalized:
            raise RuntimeError("StreamingAggregator already finalized")
        if self._es is None:
            state, dstats = self.finalize_device()
            return state, self._patch_stats(dstats.finalize())
        pre, out_cap, trim = self._merge_plan(bucketed=False)
        es, self._es = self._es, None
        self._finalized = True
        state, dstats = self._run_merge(es, pre, out_cap, trim)
        try:
            stats = dstats.finalize()
        except ExchangeOverflowError as e:
            state, stats = self._retry_exchange("finalize", e, es, pre, out_cap, trim, False)
        except MergeOverflowError as e:
            # the drain wrote the same rows into the same slots: a re-run reads them again
            state, stats = self._retry_capacity("finalize", e, es, pre, out_cap, trim, False)
        return state, self._patch_stats(stats)

    # -- merge-on-read snapshots + eviction (the service protocol) -------

    def _merge_plan(self, *, bucketed: bool) -> tuple[int, int, int]:
        """``(premerge_levels, out_capacity, trim)``: the levels from the
        exact slot bound (as the one-shot pipeline plans them); ``bucketed``
        (snapshots) pow2-buckets the capacities."""
        from repro_torch.core.insort import plan_pre_merge_levels  # lazy: avoids a cycle

        est = (self.cfg.memory_rows * self.cfg.fanin if self.output_estimate is None
               else self.output_estimate)
        rows_loc = self.rows_padded // self.world
        r_static = self._bound_total(self._rows_since_evict)
        pre = plan_pre_merge_levels(est, self.cfg, r_static)
        if bucketed:
            out_cap = self.output_rows or _pow2_ceil(max(1, rows_loc))
            trim = min(_pow2_ceil(r_static), self._R)
        else:
            out_cap = max(1, self.output_rows or rows_loc)
            trim = min(r_static, self._R)
        return pre, out_cap, trim

    def _run_merge(self, es, pre: int, out_cap: int, trim: int, copy_store: bool = False,
                   exchange_quota: int | None = None):
        """Drain + merge of ``es`` (and on a mesh the exchange, at
        ``exchange_quota`` when given: the retry's)."""
        out, dstats = _finalize_stream(
            es, self._retired or 0, policy=self._arm, page_rows=self.cfg.page_rows,
            index_rows=self.index_rows, fanin=self.cfg.fanin, premerge_levels=pre,
            backend=self.backend, out_capacity=out_cap, trim=trim, copy_store=copy_store)
        if self.mesh is None:
            return out, dstats
        return _mesh_exchange(out, dstats, self.mesh, backend=self.backend,
                              quota=exchange_quota, page_rows=self.cfg.page_rows)

    def snapshot_device(self) -> tuple[AggState, DeviceSpillStats]:
        """Merge-on-read: the current aggregate without consuming the
        engine.  The drain writes into a copy of the run store and the
        merge into a fresh output, so every tensor of the engine stays as
        it was and ingest continues afterwards."""
        if self._finalized:
            raise RuntimeError("StreamingAggregator already finalized")
        if self._es is None:
            return self._empty_result()
        pre, out_cap, trim = self._merge_plan(bucketed=True)
        return self._run_merge(self._es, pre, out_cap, trim, copy_store=True)

    def snapshot(self) -> tuple[AggState, SpillStats]:
        """:meth:`snapshot_device` + the stats' readback; a merge-output
        overflow is retried once at the next pow2 capacity."""
        state, dstats = self.snapshot_device()
        try:
            stats = dstats.finalize(entry_point="snapshot")
        except ExchangeOverflowError as e:
            pre, out_cap, trim = self._merge_plan(bucketed=True)
            state, stats = self._retry_exchange("snapshot", e, self._es, pre, out_cap, trim,
                                                True)
        except MergeOverflowError as e:
            pre, out_cap, trim = self._merge_plan(bucketed=True)
            state, stats = self._retry_capacity("snapshot", e, self._es, pre, out_cap, trim,
                                                True)
        return state, self._patch_stats(stats)

    def evict_below(self, threshold) -> int:
        """Retire every resident row whose key is below ``threshold`` from
        the live engine (TTL / watermark eviction) and re-anchor the slot
        accounting at the new high-water mark; one readback.  Retired rows
        surface as ``SpillStats.rows_retired`` on every later snapshot and
        finalize.  Returns the cumulative retired-row count.  On a mesh each
        rank retires from its own engine, the slot accounting re-anchors at
        the ranks' highest run slot and the count returned is the ranks'
        sum (two collectives of host ints)."""
        if self._finalized:
            raise RuntimeError("StreamingAggregator already finalized")
        thr = int(threshold)
        if not 0 <= thr <= int(max_key(self.key_dtype)):
            raise ValueError(
                f"eviction threshold {threshold!r} out of range for {self.key_dtype} keys "
                "(must be <= max_key, below the EMPTY sentinel)")
        if self._es is None:  # nothing resident: nothing to retire
            return self._retired_total()
        mapped = int(keys_to_torch(np.asarray([thr], self.key_dtype), "cpu")[0])
        self._retired = (self._retired or 0) + _evict_compact(self._es, mapped)
        slack = {"traditional": 0, "inrun_dedup": 0, "early_agg": 2, "rs": 4,
                 "adaptive": 6}[self.policy]
        ridx = self._es.ridx
        if self.mesh is not None:
            from repro_torch.distributed import sharding

            (ridx,) = sharding.host_all_reduce(self.mesh, [ridx], "max")
        self._base_slots = ridx + slack
        self._rows_since_evict = 0
        return self._retired_total()

    def _retired_total(self) -> int:
        """The rows eviction retired so far, over every rank of a mesh."""
        if self.mesh is None:
            return self._retired or 0
        from repro_torch.distributed import sharding

        return sharding.host_all_reduce(self.mesh, [self._retired or 0], "sum")[0]


def _as_chunk(c):
    """One element of a chunk stream as ``(keys, payload)``."""
    if isinstance(c, (tuple, list)):
        if len(c) != 2:
            raise ValueError("chunk must be a keys array or a (keys, payload) pair, got a "
                             f"{type(c).__name__} of length {len(c)}")
        return c[0], c[1]
    return c, None


def _concat_chunks(kbuf, pbuf):
    keys = np.concatenate(kbuf) if len(kbuf) > 1 else kbuf[0]
    if any(p is None for p in pbuf):
        return keys, None
    pb = [p[:, None] if p.ndim == 1 else p for p in pbuf]
    return keys, np.concatenate(pb) if len(pb) > 1 else pb[0]


def rebatch_chunks(chunks, rows: int):
    """Re-chunk an iterable of ``keys`` / ``(keys, payload)`` chunks into
    ``rows``-row chunks (host NumPy); the final partial chunk comes as
    it is."""
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    kbuf: list[np.ndarray] = []
    pbuf: list = []
    have = 0
    for c in chunks:
        k, p = _as_chunk(c)
        k = np.asarray(k)
        if k.shape[0] == 0:
            continue
        kbuf.append(k)
        pbuf.append(None if p is None else np.asarray(p))
        have += k.shape[0]
        while have >= rows:
            keys, pay = _concat_chunks(kbuf, pbuf)
            yield keys[:rows], None if pay is None else pay[:rows]
            kbuf = [keys[rows:]] if keys.shape[0] > rows else []
            pbuf = ([pay[rows:]] if pay is not None and keys.shape[0] > rows
                    else [None] * len(kbuf))
            have -= rows
    if have:
        yield _concat_chunks(kbuf, pbuf)


def _stream_setup(chunks, cfg: ExecConfig, *, policy: str = "rs", backend: str = "auto",
                  widths=None, key_dtype=None, width=None, index_rows=None,
                  output_estimate=None, output_rows=None, super_batch_rows=None, mesh=None,
                  mesh_axis=None, governor=None, device="cuda"):
    """Peek the first non-empty chunk to fix the schema and build the
    aggregator.  Returns ``(agg, stream)``; for an empty stream ``agg`` is
    None and ``stream`` the empty ``(state, DeviceSpillStats)``."""
    dev = resolve_device(device)
    it = iter(chunks)
    first = None
    for c in it:
        k, p = _as_chunk(c)
        if np.asarray(k).shape[0]:
            first = (np.asarray(k), p)
            break
    if first is None:  # as the one-shot path's empty input
        kd = np.dtype(key_dtype or np.uint32)
        return None, (empty_state(0, int(width or 0), key_dtype=kd, widths=widths, device=dev),
                      DeviceSpillStats.zeros())
    if key_dtype is None:
        key_dtype = canon_keys(first[0]).dtype
    if width is None:
        width = 0 if first[1] is None else (1 if np.asarray(first[1]).ndim == 1
                                            else np.asarray(first[1]).shape[1])
    stream = itertools.chain([first], (_as_chunk(c) for c in it))
    if super_batch_rows:
        stream = rebatch_chunks(stream, super_batch_rows)
    agg = StreamingAggregator(cfg, policy=policy, key_dtype=key_dtype, width=width,
                              widths=widths, backend=backend, index_rows=index_rows,
                              output_estimate=output_estimate, output_rows=output_rows,
                              mesh=mesh, mesh_axis=mesh_axis, governor=governor, device=dev)
    return agg, stream


def _drive(agg: StreamingAggregator, stream) -> None:
    """The double-buffered loop: stage chunk k+1, then absorb chunk k."""
    staged = None
    for keys, payload in stream:
        nxt = agg.stage(keys, payload)
        agg.absorb_staged(staged)
        staged = nxt
    agg.absorb_staged(staged)


def aggregate_device_stream(chunks, cfg: ExecConfig | None = None, **kw
                            ) -> tuple[AggState, DeviceSpillStats]:
    """The streamed twin of :func:`aggregate_device`: aggregate an input
    that never needs to be resident at once.  ``chunks`` is an iterable of
    ``keys`` arrays or ``(keys, payload)`` pairs (host NumPy); each chunk is
    staged before the previous one is absorbed, so the copy of chunk k+1
    overlaps the absorb of chunk k.  Keywords as :class:`StreamingAggregator`
    takes them, plus ``super_batch_rows`` (re-chunk the stream to that many
    rows an absorb); ``key_dtype``/``width`` default to the first chunk's.

    For any chunking whose chunk sizes are multiples of the engine's input
    batch (``memory_rows`` for the read-sort-write policies, ``batch_rows``
    for early_agg and rs), the result's rows and ``SpillStats`` equal the
    one-shot pipeline's on the concatenated input."""
    agg, stream = _stream_setup(chunks, cfg or ExecConfig(), **kw)
    if agg is None:
        return stream
    _drive(agg, stream)
    return agg.finalize_device()


def insort_aggregate_device_stream(chunks, cfg: ExecConfig | None = None, **kw
                                   ) -> tuple[AggState, SpillStats]:
    """:func:`aggregate_device_stream` + the stats' readback.  Adaptive
    streams finalize through :meth:`StreamingAggregator.finalize` (the retry
    and the observation block on the stats)."""
    if kw.get("policy") != "adaptive":
        state, dstats = aggregate_device_stream(chunks, cfg, **kw)
        return state, dstats.finalize()
    agg, stream = _stream_setup(chunks, cfg or ExecConfig(), **kw)
    if agg is None:
        state, dstats = stream
        return state, dstats.finalize()
    _drive(agg, stream)
    return agg.finalize()

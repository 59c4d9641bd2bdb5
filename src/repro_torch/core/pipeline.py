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

import torch

from repro_torch.core import dispatch
from repro_torch.core import merge as merge_mod
from repro_torch.core import run_generation as rg
from repro_torch.core import sorted_ops
from repro_torch.core.types import (
    FIELDS,
    AggState,
    DeviceSpillStats,
    ExecConfig,
    SpillStats,
    StreamEngineState,
    canon_keys,
    canon_payload,
    empty_like,
    empty_state,
    host_ints,
    keys_to_torch,
    resolve_device,
    rows_to_state,
    zero_key,
)

POLICIES = ("traditional", "inrun_dedup", "early_agg", "rs")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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


def _step_sortwrite(es: StreamEngineState, ck: torch.Tensor, cp, *, dedup: bool,
                    backend: str, ws) -> None:
    """``traditional`` / ``inrun_dedup``: one run per M-row batch, sorted
    (and with ``dedup`` combined), written to the next run slot; a batch
    with no valid row writes nothing."""
    st = rows_to_state(ck, cp, key_dtype=es.store.key_dtype, widths=ws)
    st = (sorted_ops.absorb if dedup else sorted_ops.sort_state)(st, backend=backend)
    (occ,) = host_ints(st.occupancy())
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
    (occ,) = host_ints(merged.occupancy())
    if occ > M:
        _write_slot(es.store, es.ridx, 0, merged)
        if es.ridx < es.run_slots:
            es.lens[es.ridx] = occ
        es.ridx += 1
        es.spilled += occ
        es.table = empty_like(es.table, es.table.capacity)
    else:
        cap = es.table.capacity
        es.table = merged.map(lambda x: x[:cap])


def _step_rs(es: StreamEngineState, ck: torch.Tensor, cp, *, M: int, B: int, backend: str,
             ws) -> None:
    """Replacement selection (§3.3), one input batch: absorb the sorted,
    deduped batch into the two partitions, then evict B-row quanta from the
    open partition (closing the run when it drains or its slot is full)
    until both partitions fit M rows.  Updates ``es`` in place."""
    C = es.slot_rows
    cap = es.table.capacity
    kd = es.table.key_dtype
    batch = sorted_ops.absorb(rows_to_state(ck, cp, key_dtype=kd, widths=ws), backend=backend)
    es.table, es.table2 = rg.rs_split_absorb(es.table, es.table2, es.frontier, batch,
                                             backend=backend)
    while True:
        occ_r, occ_n = host_ints(es.table.occupancy(), es.table2.occupancy())
        if occ_r + occ_n <= M:
            return
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
    table, spilled, nruns, overflow)`` with host ints and lists.

    ``early_agg`` mirrors the resident table into the next slot, so the
    wide merge always sees the whole picture; it counts as a spilled run
    only when earlier runs spilled (the host loop's rule).  ``rs``
    finishes the open run with the open partition's remainder (its own
    slot when there is room, the next one otherwise), then the next-run
    partition becomes the last run."""
    R, C = es.run_slots, es.slot_rows
    if policy in ("traditional", "inrun_dedup"):
        return es.store, list(es.lens), es.table, es.spilled, es.ridx, es.ridx > R
    if policy == "early_agg":
        (occ_t,) = host_ints(es.table.occupancy())
        lens = list(es.lens)
        _write_slot(es.store, es.ridx, 0, es.table)
        if es.ridx < R:
            lens[es.ridx] = occ_t
        spilled = es.spilled + occ_t if es.ridx > 0 else 0
        nruns = es.ridx + (1 if es.ridx > 0 and occ_t > 0 else 0)
        return es.store, lens, es.table, spilled, nruns, es.ridx + 1 > R
    rt, nt = es.table, es.table2
    occ_r, occ_n = host_ints(rt.occupancy(), nt.occupancy())
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
    return _slots_for(n_pad, M, 2 if policy == "early_agg" else 4)


def _static_run_slots(policy: str, n: int, M: int, B: int) -> int:
    chunk = _engine_geometry(policy, M, B, 1)[0]
    return _stream_run_slots(policy, _num_batches(n, chunk) * chunk, M)


def _stack(states: list[AggState]) -> AggState:
    return AggState(*(torch.stack([getattr(s, f) for s in states]) for f in FIELDS),
                    key_dtype=states[0].key_dtype)


def _slot(store: AggState, r: int) -> AggState:
    return store.map(lambda x: x[r])


def _pad_slots(store: AggState, lens: torch.Tensor, R_new: int):
    R, C = store.keys.shape
    extra = _stacked_empty(R_new - R, C, store.width, key_dtype=store.key_dtype,
                           widths=store.widths, device=store.device)
    store = AggState(*(torch.cat([getattr(store, f), getattr(extra, f)]) for f in FIELDS),
                     key_dtype=store.key_dtype)
    lens = torch.cat([lens, torch.zeros(R_new - R, dtype=lens.dtype, device=lens.device)])
    return store, lens


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


def _merge_phase(store: AggState, lens: torch.Tensor, spilled: int, nruns: int,
                 overflow: bool, *, page_rows: int, index_rows: int, fanin: int,
                 premerge_levels: int, backend: str, out_capacity: int):
    """Pre-merge levels + the wide merge + the stats."""
    store, lens, spill_m, msteps, mlevels = _device_premerge(
        store, lens, fanin=fanin, levels=premerge_levels, backend=backend)
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
    lens = torch.tensor(lens, dtype=torch.int64, device=dev)
    if not merge:
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


def aggregate_device(keys, payload=None, cfg: ExecConfig | None = None, *,
                     policy: str = "rs", backend: str = "auto", widths=None,
                     output_estimate: int | None = None, device="cuda") -> tuple[AggState, DeviceSpillStats]:
    """Run generation + pre-merge levels + wide merge over host input
    (``keys`` uint32/uint64, ``payload`` (N, V) float) on ``device``.
    Output is key-sorted, duplicate-free, EMPTY-padded to the batched input
    capacity; ``output_estimate`` fixes the number of pre-merge levels and
    never changes the answer."""
    cfg = cfg or ExecConfig()
    _check_policy(policy)
    keys, payload, widths, dev, backend = _prepare(keys, payload, widths, device, backend)
    if keys.shape[0] == 0:
        width = 0 if payload is None else payload.shape[1]
        return (empty_state(0, width, key_dtype=keys.dtype, widths=widths, device=dev),
                DeviceSpillStats.zeros())
    from repro_torch.core.insort import plan_pre_merge_levels  # lazy: avoids a cycle

    est = cfg.memory_rows * cfg.fanin if output_estimate is None else output_estimate
    r_static = _static_run_slots(policy, keys.shape[0], cfg.memory_rows, cfg.batch_rows)
    pre = plan_pre_merge_levels(est, cfg, r_static)
    pt = None if payload is None else torch.from_numpy(payload).to(dev)
    return _pipeline_body(
        keys_to_torch(keys, dev), pt, key_dtype=keys.dtype, policy=policy,
        memory_rows=cfg.memory_rows, batch_rows=cfg.batch_rows, page_rows=cfg.page_rows,
        index_rows=cfg.memory_rows, fanin=cfg.fanin, premerge_levels=pre,
        backend=backend, widths=widths,
    )


def insort_aggregate_device(keys, payload=None, cfg: ExecConfig | None = None, *,
                            policy: str = "rs", backend: str = "auto", widths=None,
                            output_estimate: int | None = None,
                            device="cuda") -> tuple[AggState, SpillStats]:
    """:func:`aggregate_device` + the readback of the spill stats."""
    state, dstats = aggregate_device(
        keys, payload, cfg, policy=policy, backend=backend, widths=widths,
        output_estimate=output_estimate, device=device)
    return state, dstats.finalize()

"""Relational operators built on the one in-sort engine (counterpart of
:mod:`repro.core.operators`).

The paper's thesis: one sort-based algorithm can serve as the only
aggregation algorithm for unsorted input, so ``group_by`` with
``algorithm="auto"`` always runs the in-sort operator; the hash and
sort-then-stream baselines serve the paper's comparisons.  The operators
below reuse one sort where the ordering is interesting (§2.2, §6.3,
§6.4): ``group_by_order_by`` (Fig 19), ``count_and_count_distinct``
(Fig 20), ``rollup`` (§2.2) and ``intersect_distinct`` (Figs 21/22).
"""
from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core import hash_agg as hash_mod
from repro_torch.core import insort as insort_mod
from repro_torch.core import schema as schema_mod
from repro_torch.core import sorted_ops
from repro_torch.core.ordered_index import compact_indices
from repro_torch.core.types import (
    AggState,
    ExecConfig,
    SpillStats,
    canon_keys,
    canon_payload,
    empty_key,
    host_ints,
    keys_to_numpy,
    keys_to_torch,
    resolve_device,
)

ALGORITHMS = ("auto", "insort", "hash", "f1_hash", "sort_then_stream", "inmemory")


# ---------------------------------------------------------------------------
# key packing (two grouping columns -> one uint32 key)
# ---------------------------------------------------------------------------


def pack_keys(hi, lo, lo_bits: int) -> np.ndarray:
    """Pack two non-negative integer columns into one uint32 sort key with
    ``hi`` major, on the host (the composite-key trick behind rollup and
    count-distinct)."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    return (hi << np.uint32(lo_bits)) | lo


def unpack_keys(keys, lo_bits: int) -> tuple[np.ndarray, np.ndarray]:
    keys = np.asarray(keys, dtype=np.uint32)
    return keys >> np.uint32(lo_bits), keys & np.uint32((1 << lo_bits) - 1)


# ---------------------------------------------------------------------------
# group by / distinct
# ---------------------------------------------------------------------------


def group_by(keys, payload=None, cfg: ExecConfig | None = None, *, algorithm: str = "auto",
             output_estimate: int | None = None, backend: str = "auto", widths=None,
             pipeline: str = "device", mesh=None, mesh_axis: str | None = None,
             device="cuda") -> tuple[AggState, SpillStats]:
    """Duplicate removal / grouping / aggregation of an unsorted input.

    ``algorithm``: ``"auto"`` (the in-sort operator, the paper's only
    choice), ``"insort"``, ``"hash"``, ``"f1_hash"``,
    ``"sort_then_stream"`` or ``"inmemory"`` (no budget).  Keys are
    ``uint32`` or ``uint64`` host arrays.  The in-sort operator runs the
    device pipeline by default; ``pipeline="host"`` the reference loop.

    ``keys`` may instead be an iterator of chunks — key arrays, or
    ``(keys, payload)`` pairs — absorbed through the streamed pipeline
    (in-sort on the device pipeline only; pass ``payload=None``).  ``mesh``
    (a :class:`repro_torch.distributed.sharding.Mesh`) shards the in-sort
    device pipeline over its ranks: a one-shot input is the rank's own
    rows, a chunk stream the global chunks, of which each rank keeps its
    slice."""
    cfg = cfg or ExecConfig()
    if isinstance(keys, Iterator):
        if algorithm not in ("auto", "insort") or pipeline != "device":
            raise ValueError("streamed input runs the in-sort device pipeline only "
                             f"(got algorithm={algorithm!r}, pipeline={pipeline!r})")
        if payload is not None:
            raise ValueError("with streamed input, pass payload chunks as (keys, payload) "
                             "pairs in the iterator, not payload=")
        from repro_torch.core import pipeline as pipeline_mod

        return pipeline_mod.insort_aggregate_device_stream(
            keys, cfg, backend=backend, widths=widths, output_estimate=output_estimate,
            mesh=mesh, mesh_axis=mesh_axis, device=device)
    if algorithm in ("auto", "insort"):
        return insort_mod.insort_aggregate(
            keys, payload, cfg, output_estimate=output_estimate, backend=backend,
            widths=widths, pipeline=pipeline, mesh=mesh, mesh_axis=mesh_axis, device=device)
    if mesh is not None:
        raise ValueError(f"mesh-sharded aggregation is in-sort only; algorithm {algorithm!r} "
                         "cannot shard (use algorithm='insort')")
    if algorithm == "hash":
        return hash_mod.hash_aggregate(keys, payload, cfg, output_estimate=output_estimate,
                                       backend=backend, widths=widths, device=device)
    if algorithm == "f1_hash":
        return hash_mod.f1_hash_aggregate(keys, payload, cfg, backend=backend, widths=widths,
                                          device=device)
    if algorithm == "sort_then_stream":
        return insort_mod.sort_then_stream_aggregate(keys, payload, cfg, backend=backend,
                                                     device=device)
    if algorithm == "inmemory":  # the whole input sorted in memory: no spill
        keys, payload = canon_keys(keys), canon_payload(payload)
        dev = resolve_device(device)
        pt = None if payload is None else torch.from_numpy(payload).to(dev)
        state = sorted_ops.sorted_groupby(
            keys_to_torch(keys, dev), pt, key_dtype=keys.dtype,
            backend=dispatch.resolve_backend_name(backend, dev), widths=widths)
        return state, SpillStats()
    raise ValueError(f"unknown algorithm {algorithm!r}; expected one of {ALGORITHMS}")


def distinct(keys, cfg: ExecConfig | None = None, **kw) -> tuple[AggState, SpillStats]:
    """SELECT DISTINCT: grouping with no payload."""
    return group_by(keys, None, cfg, **kw)


def group_by_order_by(keys, payload=None, cfg=None, *, algorithm: str = "auto", **kw):
    """GROUP BY g ORDER BY g (Fig 19).  The in-sort output is sorted
    already; a hash result needs one more full sort (its rows returned as
    ``extra_sort_rows``)."""
    state, stats = group_by(keys, payload, cfg, algorithm=algorithm, **kw)
    extra_sort_rows = 0
    if algorithm in ("hash", "f1_hash"):
        state = sorted_ops.sort_state(state)  # hash order -> key order
        (extra_sort_rows,) = host_ints(state.occupancy())
    return state, stats, extra_sort_rows


def _hi_or_empty(state: AggState, lo_bits: int) -> torch.Tensor:
    """The major column of u32 composite keys, EMPTY where a row is."""
    return torch.where(state.valid(), state.keys >> lo_bits, state.empty)


def _count_planes(state: AggState) -> torch.Tensor:
    """[count, valid] of each row, the payload of the per-g grouping."""
    return torch.stack([state.count.to(torch.float32), state.valid().to(torch.float32)], 1)


def count_and_count_distinct(g, a, lo_bits: int, cfg=None, *, algorithm: str = "auto", **kw):
    """``select g, count(a), count(distinct a) ... group by g`` (Fig 20).

    Sort-based: one sort on the composite key (g, a); the DISTINCT on
    (g, a) and the per-g grouping use the same ordering.  Hash-based:
    two hash aggregations, whose spills add."""
    packed = pack_keys(g, a, lo_bits)
    if algorithm in ("auto", "insort"):
        # one memory-intensive operation (the sort); both results fall out
        dedup, stats = group_by(packed, None, cfg, algorithm="insort", **kw)
        # count(a) = the sum of per-(g, a) counts; count(distinct a) = rows
        per_g = sorted_ops.sorted_groupby(_hi_or_empty(dedup, lo_bits), _count_planes(dedup),
                                          key_dtype=np.uint32)
        return per_g, stats
    # the hash plan: two independent hash aggregations
    dedup, s1 = group_by(packed, None, cfg, algorithm="hash", **kw)
    per_g, s2 = group_by(keys_to_numpy(_hi_or_empty(dedup, lo_bits), np.uint32),
                         _count_planes(dedup).cpu().numpy(), cfg, algorithm="hash", **kw)
    s1.rows_spilled_merge += s2.total_spill_rows
    return per_g, s1


def rollup(day, month, year, payload=None, cfg=None, **kw):
    """``group by rollup(day, month, year)`` from one sort (§2.2): the
    generic :func:`repro_torch.core.schema.rollup` with the (year 23,
    month 4, day 5 bits) u32 packing and the level names ``day``,
    ``month``, ``year``, ``all``."""
    spec = schema_mod.KeySpec.of(year=23, month=4, day=5)
    cols = {"year": np.asarray(year, np.uint32), "month": np.asarray(month, np.uint32),
            "day": np.asarray(day, np.uint32)}
    aggs = ("count", "sum", "min", "max") if payload is not None else ("count",)
    out, stats = schema_mod.rollup(cols, by=spec, values=payload,
                                   aggs=schema_mod.AggSpec(*aggs), cfg=cfg, **kw)
    legacy = {"day": ("year", "month", "day"), "month": ("year", "month"),
              "year": ("year",), "all": ()}
    return {name: out[lvl].state for name, lvl in legacy.items()}, stats


def intersect_distinct(a, b, cfg=None, *, algorithm: str = "auto", **kw):
    """``select k from T1 intersect select k from T2`` (Figs 21/22).

    Sort-based: an in-sort DISTINCT of each input (each row spills at most
    once), then a merge join of the two sorted, duplicate-free streams.
    Hash-based: a hash DISTINCT of each input and a hash join that spills
    both again (rows spill twice).  Returns the common keys (an int64 key
    tensor, sorted, EMPTY-padded) and the spill accounting."""
    alg = "insort" if algorithm in ("auto", "insort") else "hash"
    da, sa = distinct(a, cfg, algorithm=alg, **kw)
    db, sb = distinct(b, cfg, algorithm=alg, **kw)
    if alg == "hash":
        da, db = sorted_ops.sort_state(da), sorted_ops.sort_state(db)
        # the hash join spills both inputs again when they pass memory
        na, nb = host_ints(da.occupancy(), db.occupancy())
        extra = na + nb if na + nb > (cfg or ExecConfig()).memory_rows else 0
        sa.rows_spilled_merge += sb.total_spill_rows + extra
    else:
        sa.rows_spilled_merge += sb.total_spill_rows
    return _merge_probe_intersect(da.keys, db.keys, da.key_dtype), sa


def _merge_probe_intersect(ka: torch.Tensor, kb: torch.Tensor, key_dtype, *,
                           backend: str = "auto") -> torch.Tensor:
    """Merge join of two sorted, duplicate-free, EMPTY-padded key vectors:
    the backend's probe (each left key's lower bound in the right keys and
    whether it is there; the probe kernel on the card), then the hits
    compacted to the front by one gather."""
    sentinel = empty_key(key_dtype)
    if ka.shape[0] == 0:
        return ka
    _, hit = dispatch.get_backend(backend, ka.device).join_probe(ka, kb, sentinel)
    src, live = compact_indices(hit)
    return torch.where(live, ka.index_select(0, src), sentinel)


def validate_against_oracle(state: AggState, keys, payload=None) -> bool:
    """NumPy oracle check of a port state (uint32 or uint64 keys): the key
    set and counts exactly, sums within rtol 2e-4."""
    keys = canon_keys(keys)
    mask = keys != np.iinfo(keys.dtype).max
    keys = keys[mask]
    uk, inv = np.unique(keys, return_inverse=True)
    got_k = keys_to_numpy(state.keys, state.key_dtype)
    got_valid = got_k != np.iinfo(got_k.dtype).max
    got = got_k[got_valid]
    order = np.argsort(got, kind="stable")
    assert np.array_equal(np.sort(got), uk), "key sets differ"
    cnt = np.zeros(len(uk), np.int64)
    np.add.at(cnt, inv, 1)
    got_cnt = state.count.cpu().numpy()[got_valid][order]
    assert np.array_equal(got_cnt, cnt), "counts differ"
    if payload is not None:
        payload = canon_payload(payload)[mask]
        sums = np.zeros((len(uk), payload.shape[1]), np.float64)
        np.add.at(sums, inv, payload.astype(np.float64))
        got_sum = state.sum.cpu().numpy().astype(np.float64)[got_valid][order]
        np.testing.assert_allclose(got_sum, sums, rtol=2e-4, atol=2e-3)
    return True

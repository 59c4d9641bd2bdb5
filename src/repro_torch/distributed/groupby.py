"""Distributed duplicate removal / grouping / aggregation (counterpart of
:mod:`repro.distributed.groupby`).

The cluster form of the paper's operator, on its own §2.1 observation
that sorting and partitioning are the same physical property:

1. local early aggregation (§3): each rank absorbs its rows' duplicates,
   so that only distinct rows go on the wire;
2. key-range exchange: the key space splits into ``world`` contiguous
   ranges at sampled cuts; the local output is sorted, so a rank's send
   buffer is two ``searchsorted`` cuts, and one ``all_to_all`` enforces
   the partitioning together with the sort;
3. local wide merge (§4): each rank merges the ``world`` sorted fragments
   it received.  Its output is sorted, and the ranks' outputs are sorted
   by (owner, key): a distributed ORDER BY for free.

The reference's ``shard_map`` collectives become ``torch.distributed``
collectives between one process a rank (:mod:`.sharding`).  The quota is
fixed before the call, so ``all_to_all_single`` takes equal splits and
reads nothing back; the rows a rank sends, its fullest segment and the
overflow flag stay on the device until the caller's one readback.  The
fragment merge reads its page count back once (``types.SYNCS``).

Overflow is loud: every place a fixed capacity can cut live rows (the
local trim to ``capacity``, the per-peer send quota, the trim after the
merge) returns a flag, and :func:`make_distributed_groupby` raises on it.

Keys are the port's int64 keys (``types``); a uint64 key lives with its
top bit flipped, so the domain's top sits next to int64's maximum and the
arithmetic on cuts saturates instead of wrapping.
"""
from __future__ import annotations

import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import merge as merge_mod
from repro_torch.core import sorted_ops
from repro_torch.core.types import (
    INT64_MIN,
    AggState,
    canon_keys,
    canon_payload,
    concat_states,
    empty_key,
    empty_like,
    host_ints,
    keys_to_torch,
    max_key,
)
from repro_torch.distributed import sharding

_log = logging.getLogger(__name__)

# the fragment merge's page when the caller passes none (the reference's)
_DEFAULT_EXCHANGE_PAGE = 256
# the page of the callers with no ExecConfig of their own (the distributed
# group-by and the mesh merge join).  The card's page loop costs a
# host-driven round of launches a page whatever its size: at 256 rows SF-10
# Q18's mesh join merged ~59,000 pages a rank in 92 s, at 2^14 rows 9.4 s
# (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 13b).  The page
# changes no row and no statistic.
FRAGMENT_PAGE_ROWS = 1 << 14


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def default_exchange_quota(capacity: int, world: int, *, headroom: int = 2,
                           floor: int = 64) -> int:
    """Per-peer send quota of a capacity-bounded exchange: the expected
    rows per owner under the sampled cuts (``capacity / world``) times a
    pow2 ``headroom``, at least ``floor`` (sample noise is additive where
    an owner expects a handful of rows), never above ``pow2(capacity)``
    (a quota at the capacity cannot overflow, so the retry ladder ends
    there).  The receive buffer is then ``world·quota ≈ headroom·capacity``
    rows, flat in ``world`` at fixed rows a rank."""
    expected = -(-capacity // world)
    want = max(headroom * expected, floor)
    return max(1, min(_pow2_ceil(want), _pow2_ceil(capacity)))


def next_exchange_quota(quota: int, capacity: int) -> int | None:
    """The quota of an overflowed exchange's one retry: the next pow2,
    capped at ``pow2(capacity)`` (a quota at the capacity of the state a
    rank sends cannot overflow); None where ``quota`` is there already and
    a retry cannot help."""
    q = min(_pow2_ceil(quota + 1), _pow2_ceil(capacity))
    return q if q > quota else None


def exchange_page_rows(quota: int, page_rows: int | None = None) -> int:
    """The fragment merge's page: the caller's page size shrunk to divide
    ``quota`` (a page cut at a fragment's end would read the next
    fragment's rows)."""
    p = max(1, min(page_rows or _DEFAULT_EXCHANGE_PAGE, quota))
    return math.gcd(quota, p)


def exchange_footprint_rows(world: int, quota: int, page_rows: int | None = None) -> int:
    """Rows resident on a rank for one exchange and its fragment merge: the
    receive buffer (``world·quota``), the merge's index, page and headroom
    (``(world + 2)·P``) and the merged output (``world·quota``)."""
    p = exchange_page_rows(quota, page_rows)
    return 2 * world * quota + (world + 2) * p


def _range_of(keys: torch.Tensor, world: int, key_dtype) -> torch.Tensor:
    """Owner of each key under contiguous range partitioning of the key
    domain (uint32 or uint64), as int32.  A uint64 key ``u`` is held as
    ``k = u - 2^63``; with ``span = 2^64 // world`` its owner is
    ``q0 + k // span + [k mod span >= span - r0]`` where ``2^63 = q0·span +
    r0`` — the unsigned division done in int64 without overflow."""
    if world == 1:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    if np.dtype(key_dtype) == np.uint32:
        owner = keys // ((1 << 32) // world)
    elif world == 2:  # span 2^63 does not fit int64: the owner is the top bit
        owner = (keys >= 0).to(torch.int64)
    else:
        span = (1 << 64) // world
        q0, r0 = divmod(1 << 63, span)
        owner = q0 + torch.div(keys, span, rounding_mode="floor") + (
            torch.remainder(keys, span) >= span - r0).to(torch.int64)
    return owner.clamp(max=world - 1).to(torch.int32)


def _local_group_sorted(keys: torch.Tensor, payload, capacity: int, *, key_dtype,
                        backend: str = "auto"):
    """Local early aggregation trimmed to ``capacity``: ``(state, dropped)``,
    ``dropped`` a device flag for live rows cut by the trim."""
    st = sorted_ops.sorted_groupby(keys, payload, key_dtype=key_dtype, backend=backend)
    return merge_mod.trim_to_capacity(st, capacity)


def _sample_local_keys(st: AggState, nsamp: int) -> torch.Tensor:
    """``nsamp`` evenly spaced keys of a sorted state's valid prefix (a
    state with no valid row gives EMPTY samples, which rank last)."""
    occ = st.occupancy().clamp(min=1)
    pos = ((torch.arange(nsamp, device=st.device) * occ) // nsamp).clamp(
        max=st.capacity - 1)
    return st.keys.index_select(0, pos)


def strictify_cuts(cuts: torch.Tensor, key_dtype) -> torch.Tensor:
    """Make sampled inner cuts strictly increasing and clamp them to the
    key domain, below EMPTY: the reference's recurrence ``c'_i =
    min(max(c_i, min(c'_{i-1}, top - 1) + 1), top)``.  Its closed form is
    ``c'_i = min(top, max_{j<=i} (c_j + (i - j)))`` with every ``c_j``
    first clamped to ``top``; each ``c_j + (i - j)`` saturates at ``top``
    before it is added, since the u64 top sits one below int64's maximum.
    Under heavy skew the raw quantiles repeat; this bumps each repeat one
    key above its predecessor, and collapses cuts onto ``top`` only where
    the domain leaves no room — the same on every rank."""
    top = int(max_key(key_dtype)) if np.dtype(key_dtype) == np.uint32 else (1 << 63) - 2
    c = cuts.clamp(max=top)
    n = c.shape[0]
    if n == 0:
        return c
    i = torch.arange(n, device=c.device)
    d = i[:, None] - i[None, :]  # i - j
    cj = c[None, :].expand(n, n)
    bumped = torch.where(cj > top - d.clamp(min=0), torch.full_like(cj, top), cj + d)
    bumped = torch.where(d >= 0, bumped, torch.full_like(cj, INT64_MIN))
    return bumped.max(dim=1).values


def sample_range_cuts(states, mesh, *, nsamp: int = 64) -> torch.Tensor:
    """Sampled key-range edges over one or more sorted local states
    (sample sort): every rank gathers every rank's samples, and the
    quantiles of the sorted sample are the same ``world - 1`` inner edges
    on every rank.  Passing both sides of a join partitions both
    relations by the same cuts."""
    world = mesh.world
    key_dtype = states[0].key_dtype
    sample = torch.cat([_sample_local_keys(st, nsamp) for st in states])
    all_samp = torch.sort(sharding.all_gather(mesh, sample).reshape(-1)).values
    eidx = (torch.arange(1, world, device=all_samp.device) * all_samp.shape[0]) // world
    return strictify_cuts(all_samp.index_select(0, eidx), key_dtype)


def _pack(state: AggState) -> torch.Tensor:
    """A state's rows as one int32 buffer ``(n, 3 + Vs + Vm + Vx)``: the
    int64 key as two words, the count, the planes' bits — one collective
    for the whole state."""
    n = state.capacity
    cols = [state.keys.contiguous().view(torch.int32).reshape(n, 2), state.count[:, None]]
    cols += [getattr(state, f).contiguous().view(torch.int32) for f in ("sum", "min", "max")]
    return torch.cat(cols, dim=1)


def _unpack(buf: torch.Tensor, like: AggState) -> AggState:
    ws, wm, wx = like.widths
    keys = buf[:, :2].contiguous().view(torch.int64).reshape(-1)
    count = buf[:, 2].contiguous()
    o = 3
    planes = []
    for w in (ws, wm, wx):
        planes.append(buf[:, o:o + w].contiguous().view(torch.float32))
        o += w
    return AggState(keys, count, *planes, key_dtype=like.key_dtype)


def exchange_sorted_fragments(st: AggState, mesh, *, quota: int, nsamp: int = 64,
                              inner_cuts: torch.Tensor | None = None):
    """Key-range ``all_to_all`` of a sorted, duplicate-free local state.

    The edges are sampled (:func:`sample_range_cuts`) unless
    ``inner_cuts`` gives them (``world - 1`` keys, the same on every rank:
    the mesh merge join exchanges both sides under one cut vector).  The
    state is sorted, so segment ``i`` of the send buffer is the rows
    between two ``searchsorted`` cuts, padded with EMPTY (zeros in the
    other fields, as the reference fills them) to exactly ``quota`` rows.

    Returns ``(recv, rows_sent, send_dropped, max_fill)``, device values:
    ``recv`` holds ``world·quota`` rows, rows ``[i·quota, (i+1)·quota)``
    being rank ``i``'s sorted fragment, and the fragments' key ranges
    ascend with ``i``; ``rows_sent`` the valid rows this rank put on the
    wire; ``send_dropped`` whether a segment held more than ``quota`` rows
    (live rows left behind: the callers raise or retry on it);
    ``max_fill`` this rank's fullest segment."""
    world = mesh.world
    dev = st.device
    capacity = st.capacity
    inner = (sample_range_cuts((st,), mesh, nsamp=nsamp) if inner_cuts is None
             else inner_cuts)
    cuts = torch.searchsorted(st.keys, inner)
    cap = torch.tensor([capacity], dtype=torch.int64, device=dev)
    ends = torch.cat([cuts, cap])
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), cuts])
    occ = st.occupancy()
    seg_valid = ends.clamp(max=occ) - starts.clamp(max=occ)
    rows_sent = seg_valid.sum()
    max_fill = seg_valid.max()
    send_dropped = (seg_valid > quota).any()
    idx = starts[:, None] + torch.arange(quota, device=dev)[None, :]
    live = (idx < ends[:, None]).reshape(-1)
    idx = idx.clamp(max=capacity - 1).reshape(-1)
    send = _pack(st).index_select(0, idx)
    fill = _pack(AggState(torch.full((1,), empty_key(st.key_dtype), dtype=torch.int64,
                                     device=dev),
                          torch.zeros(1, dtype=torch.int32, device=dev),
                          *(torch.zeros((1, w), dtype=torch.float32, device=dev)
                            for w in st.widths), key_dtype=st.key_dtype))
    send = torch.where(live[:, None], send, fill)
    recv = _unpack(sharding.all_to_all(mesh, send), st)
    return recv, rows_sent, send_dropped, max_fill


def gather_state(state: AggState, mesh) -> AggState:
    """The ranks' shards side by side in rank order: sorted by (owner,
    key), EMPTY-padded shard by shard, as the reference's global array but
    for the padding.  A shard's valid rows lead it, so only the first
    ``max occupancy`` rows of each travel: one readback of this rank's
    occupancy, one collective of host ints, one ``all_gather`` of ``world``
    × that many rows, which every rank receives.  Every rank must call it."""
    (occ,) = host_ints(state.occupancy())
    (rows,) = sharding.host_all_reduce(mesh, [occ], "max")
    if rows > state.capacity:  # only where the shards' capacities differ
        state = concat_states(state, empty_like(state, rows - state.capacity))
    buf = sharding.all_gather(mesh, _pack(state.map(lambda x: x[:rows])))
    return _unpack(buf.reshape(mesh.world * rows, -1), state)


class ExchangeInfo(NamedTuple):
    """Accounting of one :func:`exchange_and_merge`: device values but the
    static ``quota``; per rank (the callers reduce them over the mesh)."""

    rows_sent: torch.Tensor  # valid rows this rank put on the wire
    send_dropped: torch.Tensor  # a send segment exceeded `quota` (retryable)
    max_fill: torch.Tensor  # this rank's fullest send segment
    merge_dropped: torch.Tensor  # the fragment merge lost rows (statically impossible)
    quota: int  # the static per-peer quota the exchange ran at
    capacity: int  # the sent state's rows: the retry's lossless ceiling


def merge_received_fragments(recv: AggState, world: int, quota: int, *,
                             backend: str = "auto", page_rows: int | None = None):
    """The page-streamed wide merge (§4) of the ``world`` sorted fragments
    an exchange delivered: they are §4 runs (sorted, duplicate-free,
    EMPTY-padded), so they stream page by page through
    :func:`repro_torch.core.merge.wide_merge_device` with an index of
    ``world·page`` rows.  Returns ``(merged, dropped)``, the merged state
    at capacity ``world·quota`` and the merge's row-loss flag."""
    p = exchange_page_rows(quota, page_rows)
    store, lens = merge_mod.fragments_to_store(recv, world, quota)
    merged, _out_cur, _pages, _max_occ, _overflow, dropped = merge_mod.wide_merge_device(
        store, lens, page_rows=p, index_rows=world * p, out_capacity=world * quota,
        backend=backend)
    return merged, dropped


def exchange_and_merge(st: AggState, mesh, *, backend: str = "auto", quota: int | None = None,
                       page_rows: int | None = None):
    """Key-range exchange and per-owner merge of a sorted, duplicate-free
    local state: the shared tail of the mesh paths (the one-shot finalize,
    the streamed finalize and the service's snapshot, which feeds it a
    fresh buffer, so that the live engine is never touched).

    The quota is capacity-bounded (:func:`default_exchange_quota` unless
    given); a segment over it sets ``info.send_dropped``, which the entry
    points raise as ``ExchangeOverflowError`` and retry once at the next
    pow2 quota.  Returns ``(merged, info)``."""
    if quota is None:
        quota = default_exchange_quota(st.capacity, mesh.world)
    recv, rows_sent, send_dropped, max_fill = exchange_sorted_fragments(st, mesh, quota=quota)
    merged, merge_dropped = merge_received_fragments(recv, mesh.world, quota, backend=backend,
                                                     page_rows=page_rows)
    return merged, ExchangeInfo(rows_sent, send_dropped, max_fill, merge_dropped, quota,
                                st.capacity)


def reduce_flags(mesh, sums, maxes) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Device scalars summed and maxed over the ranks with one collective
    (an ``all_gather`` of the packed vector; flags go as int64)."""
    vec = torch.stack([torch.as_tensor(v).to(torch.int64).reshape(()) for v in (*sums, *maxes)])
    g = sharding.all_gather(mesh, vec)
    k = len(sums)
    return list(g[:, :k].sum(0)), list(g[:, k:].max(0).values)


def sharded_merge_join_local(a: AggState, b: AggState, mesh, *, how: str = "inner",
                             backend: str = "auto", nsamp: int = 64,
                             quota_a: int | None = None, quota_b: int | None = None,
                             page_rows: int = FRAGMENT_PAGE_ROWS):
    """A rank's part of the mesh merge join: both inputs are this rank's
    sorted, duplicate-free, EMPTY-tailed shards of globally sorted
    relations.  Both sides are sampled jointly (one cut vector), each is
    exchanged by those cuts and merged per owner, and the join is then
    local: owner ``i`` holds every row of both relations in key range
    ``i``.  No sort anywhere: the order survives the shuffle.

    Returns ``(left, right_or_left, rows_sent, send_dropped, dropped,
    max_fill)``: the local join trimmed back to ``|a|`` rows, the aligned
    right side (the left again for semi/anti), the shuffle volume of both
    sides summed over the ranks, the retryable quota-overflow flag and the
    row-loss flag (merge or trim), both any-rank, and the fullest send
    segment over the ranks."""
    from repro_torch.core.merge_join import merge_join  # imports nothing of this module

    world = mesh.world
    qa = default_exchange_quota(a.capacity, world) if quota_a is None else quota_a
    qb = default_exchange_quota(b.capacity, world) if quota_b is None else quota_b
    cuts = sample_range_cuts((a, b), mesh, nsamp=nsamp)
    recv_a, sent_a, drop_a, fill_a = exchange_sorted_fragments(a, mesh, quota=qa,
                                                               inner_cuts=cuts)
    recv_b, sent_b, drop_b, fill_b = exchange_sorted_fragments(b, mesh, quota=qb,
                                                               inner_cuts=cuts)
    ma, mdrop_a = merge_received_fragments(recv_a, world, qa, backend=backend,
                                           page_rows=page_rows)
    mb, mdrop_b = merge_received_fragments(recv_b, world, qb, backend=backend,
                                           page_rows=page_rows)
    left, right = merge_join(ma, mb, how=how, backend=backend)
    left, trim_l = merge_mod.trim_to_capacity(left, a.capacity)
    if right is not None:
        right, trim_r = merge_mod.trim_to_capacity(right, a.capacity)
    else:
        right, trim_r = left, torch.zeros((), dtype=torch.bool, device=a.device)
    (rows_sent,), (send_dropped, dropped, max_fill) = reduce_flags(
        mesh, (sent_a + sent_b,), (drop_a | drop_b, mdrop_a | mdrop_b | trim_l | trim_r,
                                   torch.maximum(fill_a, fill_b)))
    return left, right, rows_sent, send_dropped > 0, dropped > 0, max_fill


def make_distributed_groupby(mesh, axis: str | None = None, *, capacity: int,
                             on_overflow: str = "raise", exchange_quota: int | None = None,
                             page_rows: int = FRAGMENT_PAGE_ROWS, backend: str = "auto",
                             device=None):
    """Returns ``fn(keys, payload)``, called by every rank on its own rows
    (host uint32/uint64 keys and an (n, V) float payload, or the port's
    int64 key tensor with ``key_dtype=``), which returns this rank's
    :class:`AggState` of ``capacity`` rows: its key range of the global
    result, sorted, the ranks' results sorted by rank.

    The exchange runs at a capacity-bounded quota
    (:func:`default_exchange_quota` unless ``exchange_quota``) and the
    fragment merge streams pages, so a rank holds O(quota + page) rows of
    exchange, not O(world × capacity).

    ``on_overflow="raise"`` reads the flags back after the exchange (one
    readback): a send segment over quota retries once at the next pow2
    quota with a warning, then raises; any other loss (the local trim, the
    trim after the merge) raises at once.  ``"flag"`` returns ``(state,
    dropped)`` with the any-rank device flag and no retry."""
    if on_overflow not in ("raise", "flag"):
        raise ValueError(f"unknown on_overflow {on_overflow!r}: raise|flag")
    sharding.resolve_mesh_axis(mesh, axis)
    world = mesh.world
    dev = mesh.device if device is None else torch.device(device)
    sharding.check_mesh_device(mesh, dev)

    def sharded(quota, keys, payload, key_dtype):
        st, local_dropped = _local_group_sorted(keys, payload, capacity, key_dtype=key_dtype,
                                                backend=backend)
        recv, _sent, send_dropped, _fill = exchange_sorted_fragments(st, mesh, quota=quota)
        merged, merge_dropped = merge_received_fragments(recv, world, quota, backend=backend,
                                                         page_rows=page_rows)
        merged, recv_dropped = merge_mod.trim_to_capacity(merged, capacity)
        _, (send_any, drop_any) = reduce_flags(
            mesh, (), (send_dropped, local_dropped | merge_dropped | recv_dropped))
        return merged, send_any > 0, drop_any > 0

    q0 = default_exchange_quota(capacity, world) if exchange_quota is None else exchange_quota
    quota2 = next_exchange_quota(q0, capacity)

    def run(keys, payload=None, *, key_dtype=None):
        if isinstance(keys, torch.Tensor):
            if key_dtype is None:
                raise TypeError("int64 key tensors need key_dtype= (uint32 or uint64)")
            kd, kt = np.dtype(key_dtype), keys.reshape(-1).to(dev)
        else:
            host = canon_keys(np.asarray(keys).reshape(-1))
            kd, kt = host.dtype, keys_to_torch(host, dev)
        if payload is not None and not isinstance(payload, torch.Tensor):
            payload = torch.from_numpy(canon_payload(np.asarray(payload)))
        if payload is not None:
            payload = payload.reshape(kt.shape[0], -1).to(dev, torch.float32)
        state, send_dropped, dropped = sharded(q0, kt, payload, kd)
        if on_overflow == "flag":
            return state, send_dropped | dropped
        send, lost = host_ints(send_dropped, dropped)  # one replicated readback
        if send and quota2 is not None:
            _log.warning("distributed group-by exchange overflowed its per-peer quota=%d; "
                         "retrying once at quota=%d", q0, quota2)
            state, send_dropped, dropped = sharded(quota2, kt, payload, kd)
            send, lost = host_ints(send_dropped, dropped)
        if send or lost:
            raise RuntimeError(
                "distributed group-by dropped rows: a send segment exceeded the per-peer "
                "exchange quota even after one retry, or received fragments exceeded "
                f"capacity={capacity} on at least one rank — raise `capacity` (results "
                "would be missing keys/counts)")
        return state

    return run


def sparse_embedding_grad(tokens, grads, vocab: int, mesh, axis: str | None = None,
                          capacity: int | None = None, on_overflow: str = "raise"):
    """Aggregate this rank's (token, gradient row) pairs across the ranks,
    sort-based: only distinct rows go on the wire.  Returns the rank's
    key range of the aggregated state (``on_overflow="flag"``: with the
    row-loss flag).  ``capacity`` defaults to the reference's, the global
    token count: ``world`` times the most tokens a rank holds (one
    collective of a host int)."""
    grads = torch.as_tensor(grads) if not isinstance(grads, torch.Tensor) else grads
    d = grads.shape[-1]
    tokens = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor) else tokens)
    capacity = capacity or mesh.world * sharding.host_all_reduce(mesh, [tokens.size], "max")[0]
    gb = make_distributed_groupby(mesh, axis, capacity=capacity, on_overflow=on_overflow)
    return gb(tokens.reshape(-1).astype(np.uint32), grads.reshape(-1, d))


"""Hash-aggregation baselines the paper compares against (counterpart of
:mod:`repro.core.hash_agg`), both with exact spill accounting:

* :func:`hash_aggregate` — hybrid hash aggregation: an in-memory table
  absorbs matches; on overflow the hash space is partitioned F ways per
  level, recursively, until a partition's output fits memory (Examples
  3–5, Figs 23/24); a resident share of the hash range stays in memory.
* :func:`f1_hash_aggregate` — F1 Query's pre-paper scheme (§5, Figs
  17/18): early aggregation in an overflowing table that is sorted and
  written as a run, runs merged without aggregation, duplicates removed
  only in the final merge.

The hash is a fixed odd multiplicative constant per key width, a
bijection on the unsigned domain, so equal hashes are equal keys: "hashing
is in fact equivalent to sorting by hash value", and the machinery below
runs the ordered-index primitives on hashed keys.  The result's order is
hash order, not key order.

The hash is computed in the unsigned domain.  On the host (NumPy) that is
``uint32``/``uint64`` arithmetic, as the reference does it; the partition
edges compare there too.  On the device, where keys are int64 (u64 keys
with their top bit flipped), :func:`unhash_keys` unflips, multiplies with
wrap-around (int64 multiplication is unsigned multiplication mod 2^64) and
flips back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dispatch, sorted_ops
from repro_torch.core import merge as merge_mod
from repro_torch.core import run_generation as rg
from repro_torch.core.types import (
    INT64_MIN,
    AggState,
    ExecConfig,
    SpillStats,
    canon_keys,
    canon_payload,
    keys_to_torch,
    resolve_device,
)

_KNUTH = np.uint32(2654435761)
_KNUTH_INV = np.uint32(pow(int(_KNUTH), -1, 1 << 32))
# the 64-bit twin: the odd Fibonacci-hashing constant floor(2^64/phi) | 1
_KNUTH64 = np.uint64(0x9E3779B97F4A7C15)
_KNUTH64_INV = np.uint64(pow(int(_KNUTH64), -1, 1 << 64))
_EMPTY_NP = {32: np.uint32(0xFFFFFFFF), 64: np.uint64(0xFFFFFFFFFFFFFFFF)}


def _consts(dtype):
    if np.dtype(dtype) == np.uint64:
        return _KNUTH64, _KNUTH64_INV, 64
    return _KNUTH, _KNUTH_INV, 32


def _as_int64(c) -> int:
    """A 64-bit unsigned constant as the int64 with its bit pattern."""
    c = int(c)
    return c - (1 << 64) if c >= 1 << 63 else c


def _mul_keys(keys: torch.Tensor, c, key_dtype) -> torch.Tensor:
    """``keys * c`` in the unsigned domain of ``key_dtype``, on the port's
    int64 key tensors."""
    if np.dtype(key_dtype) == np.uint64:
        return (keys ^ INT64_MIN) * _as_int64(c) ^ INT64_MIN
    return (keys * int(c)) & 0xFFFFFFFF


def hash_u32(keys: torch.Tensor) -> torch.Tensor:
    """The multiplicative hash of u32-domain int64 keys."""
    return _mul_keys(keys, _KNUTH, np.uint32)


def unhash_u32(hkeys: torch.Tensor) -> torch.Tensor:
    return _mul_keys(hkeys, _KNUTH_INV, np.uint32)


def unhash_keys(hkeys: torch.Tensor, key_dtype) -> torch.Tensor:
    """Invert the multiplicative hash in the key domain ``key_dtype``."""
    return _mul_keys(hkeys, _consts(key_dtype)[1], key_dtype)


def _np_hash(keys: np.ndarray) -> np.ndarray:
    mul, _, bits = _consts(keys.dtype)
    if bits == 64:
        with np.errstate(over="ignore"):
            return (keys.astype(np.uint64) * mul).astype(np.uint64)
    return (keys.astype(np.uint64) * np.uint64(int(mul)) % (1 << 32)).astype(np.uint32)


def _np_unhash(hkeys: np.ndarray) -> np.ndarray:
    _, inv, bits = _consts(hkeys.dtype)
    if bits == 64:
        with np.errstate(over="ignore"):
            return (hkeys.astype(np.uint64) * inv).astype(np.uint64)
    return (hkeys.astype(np.uint64) * np.uint64(int(inv)) % (1 << 32)).astype(np.uint32)


def _checked_hash(keys: np.ndarray) -> np.ndarray:
    """Hash with the sentinel guard: the hash is a bijection, so exactly one
    valid key maps onto EMPTY (EMPTY times the inverse), and a row
    carrying it would vanish inside the engine.  Fail loudly instead; the
    in-sort operator has no such restriction."""
    hk = _np_hash(keys)
    sentinel = _EMPTY_NP[_consts(keys.dtype)[2]]
    if bool((hk == sentinel).any()):
        bad = _np_unhash(np.asarray([sentinel], dtype=keys.dtype))[0]
        raise ValueError(
            f"key {int(bad)} hashes to the reserved EMPTY sentinel and is unsupported by "
            "the hash baselines; use the sort-based operator")
    return hk


def _unhashed(state: AggState) -> AggState:
    """The state with user keys in place of hashes; the order stays hash
    order."""
    keys = torch.where(state.valid(), unhash_keys(state.keys, state.key_dtype), state.empty)
    return AggState(keys, state.count, state.sum, state.min, state.max, state.key_dtype)


def _strip_sentinel(keys: np.ndarray, payload):
    """Drop the rows that carry the EMPTY sentinel: they are not data."""
    mask = keys != _EMPTY_NP[_consts(keys.dtype)[2]]
    if mask.all():
        return keys, payload
    return keys[mask], None if payload is None else payload[mask]


def hash_aggregate(keys, payload=None, cfg: ExecConfig | None = None, *,
                   output_estimate: int | None = None, hybrid: bool = True,
                   backend: str = "auto", widths=None,
                   device="cuda") -> tuple[AggState, SpillStats]:
    """Hybrid hash aggregation with recursive overflow partitioning.  The
    result's keys are the user's, in hash order: not usefully sorted for
    a downstream consumer, the interesting-orderings deficit the paper's
    operator removes.  ``output_estimate`` is accepted for the front
    door's symmetry and not used, as in the reference."""
    del output_estimate
    cfg = cfg or ExecConfig()
    dev = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend, dev)
    stats = SpillStats()
    keys = canon_keys(keys)
    key_bits = _consts(keys.dtype)[2]
    keys, payload = _strip_sentinel(keys, canon_payload(payload))
    hk = _checked_hash(keys)
    M, F = cfg.memory_rows, cfg.fanin
    outputs: list[AggState] = []

    def in_memory(hkeys, pay):
        pt = None if pay is None else torch.from_numpy(np.ascontiguousarray(pay)).to(dev)
        outputs.append(sorted_ops.sorted_groupby(keys_to_torch(hkeys, dev), pt,
                                                 key_dtype=keys.dtype, backend=backend,
                                                 widths=widths))

    def process(hkeys, pay, level: int, lo: int, hi: int):
        """Aggregate the hash sub-range [lo, hi); recurse on overflow."""
        uniq = len(np.unique(hkeys))
        if uniq <= M:
            in_memory(hkeys, pay)
            return
        # overflow: hybrid hashing keeps a resident slice of this sub-range
        resident_frac = (M / uniq) if hybrid else 0.0
        cut = lo + int(resident_frac * (hi - lo))
        if cut < (1 << key_bits):
            resident = hkeys < np.asarray(cut, dtype=hkeys.dtype)
        else:
            resident = np.ones_like(hkeys, bool)
        if resident.any():
            in_memory(hkeys[resident], None if pay is None else pay[resident])
        rest_k, rest_p = hkeys[~resident], None if pay is None else pay[~resident]
        # hash-partition the overflow into F spill partitions (one write each)
        stats.rows_spilled_merge += len(rest_k)
        stats.merge_levels = max(stats.merge_levels, level + 1)
        # integer edges: a float linspace loses precision at 2^64
        edges = [cut + (hi - cut) * i // F for i in range(F + 1)]
        part = np.digitize(rest_k, np.asarray(edges[1:-1], dtype=hkeys.dtype), right=False)
        for f in range(F):
            m = part == f
            if m.any():
                stats.merge_steps += 1
                process(rest_k[m], None if rest_p is None else rest_p[m], level + 1,
                        edges[f], edges[f + 1])

    process(hk, payload, 0, 0, 1 << key_bits)
    # each partition's output is sorted by hash over a disjoint hash range:
    # a tree of linear merges orders the union, no sort
    cat = sorted_ops.merge_absorb_many(outputs, backend=backend, assume_unique=True)
    return _unhashed(cat), stats


def f1_hash_aggregate(keys, payload=None, cfg: ExecConfig | None = None, *,
                      backend: str = "auto", widths=None,
                      device="cuda") -> tuple[AggState, SpillStats]:
    """The pre-paper F1 scheme: early aggregation in a hash table, spilled
    as sorted runs, merged without aggregation, duplicates removed only in
    the final merge (Figs 17/18).  The overflowing hash table is the
    early-aggregation index over hashed keys: the same absorption, the
    same runs (§6.2)."""
    cfg = cfg or ExecConfig()
    dev = resolve_device(device)
    backend = dispatch.resolve_backend_name(backend, dev)
    keys, payload = _strip_sentinel(canon_keys(keys), canon_payload(payload))
    hk = _checked_hash(keys)
    runs, table, stats = rg.generate_runs(hk, payload, cfg, policy="early_agg",
                                          backend=backend, widths=widths, device=dev)
    if table is not None:
        out = table
    else:
        out = merge_mod.final_merge_traditional(runs, cfg, aggregate=False, stats=stats,
                                                backend=backend)
    return _unhashed(out), stats


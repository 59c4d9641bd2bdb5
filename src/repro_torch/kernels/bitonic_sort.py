"""Stable argsort of int64 keys: the CUDA kernel of ``csrc/argsort.cu``
and its plain version.

Counterpart of :mod:`repro.kernels.bitonic_sort` as reached through
``ops.argsort_keys``.  Pairs of (key, row index) are compared, so the
order is the stable one, as the reference's index lane makes it.  The
kernel has four size classes (:func:`plan`): a warp's shuffle network, one
block's merge sort in shared memory, one thread-block cluster that merges
its CTAs' runs through distributed shared memory (one launch each, up to
65,536 keys), and above that, clusters and merge passes through device
memory.

``bitonic_sort`` / ``bitonic_sort_kv`` are the reference's tile-batch
sorts: each row of a ``(T, N)`` batch of 32-bit keys sorted, as one
argsort of ``(row << 32) | key`` through ``ops.argsort_keys``.
"""
from __future__ import annotations

import torch

from repro_torch.core.ordered_index import argsort_torch as argsort_plain  # noqa: F401
from repro_torch.kernels import _build

WARP_PAIRS = 32  # one warp, one pair a lane
BLOCK_PAIRS = 1024  # one block's merge sort in shared memory
CTA_PAIRS = (1024, 4096)  # the least and most pairs a CTA of a cluster sorts
CLUSTER_CTAS = 16  # a non-portable cluster size (the portable one is 8)
LARGE = ("large", 2048, 16)  # above a cluster: clusters, then merge passes
# 32-bit row indices, the padding of a cluster's chunk included
MAX_KEYS = (1 << 31) - 1 - CTA_PAIRS[1] * CLUSTER_CTAS
_VARIANTS = {"warp": 0, "block": 1, "cluster": 2, "large": 3}
_ARGS = [_build.P, _build.LL, _build.I, _build.I, _build.I] + [_build.P] * 6


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def plan(n: int) -> tuple[str, int, int]:
    """``(variant, tile, cluster)`` of the argsort of ``n`` keys, from ``n``
    alone: ``("warp", 32, 1)`` up to 32 keys; ``("block", t, 1)`` up to
    1,024, ``t`` the next power of two (at least 64: 8 pairs a thread);
    up to 16 CTAs of 4,096 pairs ``("cluster", t, c)``, CTAs of ``t`` pairs,
    the next power of two of ``n / 16`` but at least 1,024, and ``c`` the
    next power of two of the CTAs ``n`` fills; ``LARGE`` above.  A CTA's
    merge rounds are bound by its shared memory, so past 1,024 keys a
    cluster of small CTAs outruns one large block; 65,536 keys take the
    largest cluster, 16 CTAs of 4,096 (``scripts/argsort_plans.py`` times
    every plan the kernel allows; PERF.md).  The wrapper passes the plan to
    the C entry point, which refuses one its input does not allow."""
    if n <= WARP_PAIRS:
        return "warp", WARP_PAIRS, 1
    if n <= BLOCK_PAIRS:
        return "block", max(64, _pow2_at_least(n)), 1
    if n <= CTA_PAIRS[1] * CLUSTER_CTAS:
        tile = max(CTA_PAIRS[0], _pow2_at_least(-(-n // CLUSTER_CTAS)))
        return "cluster", tile, _pow2_at_least(-(-n // tile))
    return LARGE


def argsort_cuda(keys: torch.Tensor) -> torch.Tensor:
    """Launch the argsort kernel on ``keys`` (contiguous 1-D int64 on a
    CUDA device); returns the int32 permutation."""
    _build.check(keys, torch.int64, "keys", ndim=1)
    n = keys.shape[0]
    if n > MAX_KEYS:
        raise ValueError(f"argsort of {n} keys: row indices are 32-bit (at most {MAX_KEYS})")
    variant, tile, cluster = plan(n)
    f = _build.fn("argsort", "repro_argsort", _ARGS)
    perm = torch.empty((n,), dtype=torch.int32, device=keys.device)
    bufs = [None] * 4
    if variant == "large":  # sorted chunks and merge passes through device memory
        kbuf = torch.empty((2, n), dtype=torch.int64, device=keys.device)
        ibuf = torch.empty((2, n), dtype=torch.int32, device=keys.device)
        bufs = [kbuf[0].data_ptr(), ibuf[0].data_ptr(), kbuf[1].data_ptr(), ibuf[1].data_ptr()]
    err = f(keys.data_ptr(), n, _VARIANTS[variant], tile, cluster, *bufs, perm.data_ptr(),
            _build.stream_of(keys))
    _build.raise_on(err, f"argsort ({variant}, tile {tile}, cluster {cluster})")
    return perm


def _row_major_perm(keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts each row of a ``(T, N)`` batch of keys in
    ``[0, 2^32)`` (the reference's uint32 lanes): one argsort of
    ``(row << 32) | key`` (stable, so equal keys keep their order), as
    flat indices whose row ``t`` lies in ``[t N, (t + 1) N)``."""
    from repro_torch.kernels import ops  # ops imports this module

    if keys.ndim != 2:
        raise ValueError(f"keys must be a (T, N) batch, got shape {tuple(keys.shape)}")
    t, n = keys.shape
    keys = keys.to(torch.int64)
    if keys.numel():
        lo, hi = torch.stack([keys.min(), keys.max()]).tolist()
        if lo < 0 or hi > 0xFFFFFFFF:
            raise ValueError(f"keys span [{lo}, {hi}]: the tile sort takes 32-bit keys "
                             "(the reference's uint32 lanes)")
    rows = torch.arange(t, dtype=torch.int64, device=keys.device)
    packed = ((rows[:, None] << 32) | keys).reshape(-1)
    return ops.argsort_keys(packed)


def bitonic_sort(keys: torch.Tensor) -> torch.Tensor:
    """Sort each row of a ``(T, N)`` batch of 32-bit keys (int64 in
    ``[0, 2^32)``; the reference's EMPTY, ``2^32 - 1``, sorts last)."""
    perm = _row_major_perm(keys)
    return keys.reshape(-1)[perm].view(keys.shape)


def bitonic_sort_kv(keys: torch.Tensor, vals: torch.Tensor):
    """Key-sort each row with a payload ``vals`` of the keys' shape moved
    alongside; returns ``(sorted keys, moved vals)``.  Among equal keys the
    payload keeps its order (the reference's network leaves that order
    undefined)."""
    if vals.shape != keys.shape:
        raise ValueError(f"vals shape {tuple(vals.shape)} != keys shape {tuple(keys.shape)}")
    perm = _row_major_perm(keys)
    return keys.reshape(-1)[perm].view(keys.shape), vals.reshape(-1)[perm].view(vals.shape)

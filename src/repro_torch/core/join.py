"""Join by grouping (paper §2.5, Fig 4) over raw rows, with one mixed sort
(counterpart of :mod:`repro.core.join`).

Both inputs' rows go into one aggregation keyed by the join key, with the
side carried in the payload: per key, the combined packet holds |L|, |R|
and each side's payload sums, which is enough for COUNT/SUM/AVG
group-joins (|L|·|R| and the cross sums).  The aggregation is the port's
in-sort operator (:func:`repro_torch.core.insort.insort_aggregate`), so
the join runs through the kernels the aggregate runs through and needs no
kernel of its own.  Its sibling :mod:`repro_torch.core.merge_join` joins
two relations that were aggregated separately, with no sort at all.

:func:`resolve_join_keys` is NumPy code copied from the reference.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core import insort as insort_mod
from repro_torch.core.types import ExecConfig, keys_to_numpy


def _pack_side(side, by) -> np.ndarray:
    """One side's join keys → a packed key vector of ``by.key_dtype``."""
    if isinstance(side, Mapping):
        return by.pack(side)
    arr = np.asarray(side)
    if arr.ndim == 1 and len(by.columns) == 1:
        return by.pack([arr])
    return by.pack(side)  # significance-ordered sequence of columns


def resolve_join_keys(left_keys, right_keys, by=None):
    """Pack/validate both sides' join keys into one shared key dtype.

    With ``by`` (a :class:`~repro_torch.core.schema.KeySpec`) both sides
    pack through the same column layout.  Without it, both sides must
    already be integer vectors of the same dtype (uint32 or uint64 is
    inferred from the largest key); differing dtypes raise rather than
    truncate one side."""
    if by is not None:
        return _pack_side(left_keys, by), _pack_side(right_keys, by), by.key_dtype
    lk = np.asarray(left_keys)
    rk = np.asarray(right_keys)
    if lk.dtype != rk.dtype:
        raise TypeError(
            f"join key dtype mismatch: left is {lk.dtype}, right is {rk.dtype} — equal "
            "bit patterns would not mean equal keys. Pack both sides through one "
            "KeySpec (by=...) instead"
        )
    if lk.dtype.kind not in "ui":
        raise TypeError(f"join keys must be integers, got {lk.dtype}")
    if lk.dtype.kind == "i" and (
        (lk.size and int(lk.min()) < 0) or (rk.size and int(rk.min()) < 0)
    ):
        raise ValueError("join keys must be non-negative")
    hi = max(int(lk.max()) if lk.size else 0, int(rk.max()) if rk.size else 0)
    kd = np.dtype(np.uint64) if (lk.dtype.itemsize > 4 or hi >= 2**32 - 1) \
        else np.dtype(np.uint32)
    if hi >= int(np.iinfo(kd).max):
        raise ValueError(
            f"join key {hi} collides with the {kd} EMPTY sentinel; pack through a "
            "wider KeySpec"
        )
    return lk.astype(kd), rk.astype(kd), kd


def join_aggregate(left_keys, right_keys, left_payload=None, right_payload=None,
                   cfg: ExecConfig | None = None, *, by=None,
                   output_estimate: int | None = None, backend: str = "auto",
                   device="cuda"):
    """Aggregation-fused inner join via one mixed sort (§2.5, Fig 4).

    ``left_keys`` / ``right_keys``: integer key vectors of one dtype, or —
    with ``by=KeySpec(...)`` — column mappings packed through the spec.
    Returns ``(result, stats)``: ``result`` holds tensors on ``device``
    per sorted join key — ``keys`` (the port's int64 keys, EMPTY-padded;
    ``key_dtype`` names their domain), ``n_left``, ``n_right``,
    ``join_count`` (|L|·|R|), ``sum_left_pay`` (Σ_L payload·|R|) and
    ``sum_right_pay`` (|L|·Σ_R payload).  Only the device pipeline is
    ported; the reference runs its host loop here, with the same answer."""
    cfg = cfg or ExecConfig()
    lk, rk, key_dtype = resolve_join_keys(left_keys, right_keys, by)
    lp = (np.zeros((len(lk), 0), np.float32) if left_payload is None
          else np.asarray(left_payload, np.float32).reshape(len(lk), -1))
    rp = (np.zeros((len(rk), 0), np.float32) if right_payload is None
          else np.asarray(right_payload, np.float32).reshape(len(rk), -1))
    # the side goes in the payload, not the key: both sides share the
    # value packets of the join key (Fig 4)
    keys = np.concatenate([lk, rk]).astype(key_dtype)
    width = max(lp.shape[1], rp.shape[1], 1)
    # per-row features: [is_left, is_right, left_val…, right_val…]
    feats = np.zeros((len(keys), 2 + 2 * width), np.float32)
    feats[: len(lk), 0] = 1.0
    feats[len(lk):, 1] = 1.0
    feats[: len(lk), 2: 2 + lp.shape[1]] = lp
    feats[len(lk):, 2 + width: 2 + width + rp.shape[1]] = rp
    # only the sum plane is read below, so min and max are not carried
    state, stats = insort_mod.insort_aggregate(
        keys, feats, cfg, output_estimate=output_estimate, backend=backend,
        widths=(feats.shape[1], 0, 0), device=device,
    )
    n_l = state.sum[:, 0]
    n_r = state.sum[:, 1]
    return {
        "keys": state.keys,
        "key_dtype": state.key_dtype,
        "n_left": n_l,
        "n_right": n_r,
        "join_count": torch.where(state.valid(), n_l * n_r, 0.0),
        "sum_left_pay": state.sum[:, 2: 2 + width] * n_r[:, None],
        "sum_right_pay": state.sum[:, 2 + width:] * n_l[:, None],
    }, stats


def _keys_where(res, mask: torch.Tensor) -> np.ndarray:
    keys = keys_to_numpy(res["keys"], res["key_dtype"])
    return keys[mask.detach().cpu().numpy()]


def semi_join(left_keys, right_keys, cfg=None, **kw):
    """Distinct left keys with at least one right match, from one sort;
    returns (sorted keys as uint32/uint64, stats)."""
    res, stats = join_aggregate(left_keys, right_keys, cfg=cfg, **kw)
    return _keys_where(res, (res["n_left"] > 0) & (res["n_right"] > 0)), stats


def anti_semi_join(left_keys, right_keys, cfg=None, **kw):
    """Distinct left keys with no right match — these 'cannot be produced
    early' and fall out at the end of the same single sort."""
    res, stats = join_aggregate(left_keys, right_keys, cfg=cfg, **kw)
    return _keys_where(res, (res["n_left"] > 0) & (res["n_right"] == 0)), stats

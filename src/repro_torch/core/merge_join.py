"""Order-consuming merge join over sorted, duplicate-free states
(counterpart of :mod:`repro.core.merge_join`).

Every aggregate the port returns is key-sorted, duplicate-free and
EMPTY-padded, which is a merge join's precondition, so the join never
sorts:

* :func:`join_probe` — each left key's lower bound in the right keys and a
  hit flag, through the backend's probe (the CUDA kernel of
  ``kernels/csrc/join_probe.cu`` on the card, :func:`join_probe_torch`
  on the CPU);
* :func:`merge_join` — inner / left-semi / left-anti join: the probe, then
  one compaction gather of the kept rows (inner joins return both sides'
  packets aligned on one sorted key vector);
* :func:`group_join_products` — the §2.5 group-join columns of an inner
  join: |L|·|R| and the cross sums, straight from the two packets.

Both states must share one key domain.  The joined states keep the left
capacity: with duplicate-free sides each left key matches at most one
right key.  The gathers are plain PyTorch, as they were XLA outside any
kernel in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.core.ordered_index import compact_indices
from repro_torch.core.types import AggState, empty_key, empty_like

JOIN_HOWS = ("inner", "semi", "anti")

_INF = float("inf")


def join_probe_torch(a_keys: torch.Tensor, b_keys: torch.Tensor, empty: int):
    """Plain probe (see :func:`join_probe`): one ``searchsorted`` per left
    key, clipped into b's rows, and an equality test."""
    m = b_keys.shape[0]
    if m == 0:
        return (torch.zeros(a_keys.shape, dtype=torch.int32, device=a_keys.device),
                torch.zeros(a_keys.shape, dtype=torch.bool, device=a_keys.device))
    pos = torch.searchsorted(b_keys, a_keys).clamp_(max=m - 1)
    hit = (b_keys[pos] == a_keys) & (a_keys != empty)
    return pos.to(torch.int32), hit


def join_probe(a_keys: torch.Tensor, b_keys: torch.Tensor, key_dtype, *,
               backend: str = "auto"):
    """Rank-align each (sorted) left key against the (sorted) right keys.

    Returns ``(pos, hit)``: ``pos[i]`` (int32) is the right row holding
    ``a_keys[i]`` when ``hit[i]``, clipped into the right rows otherwise.
    EMPTY left rows never hit; the EMPTY tail of ``b_keys`` ranks after
    every valid key and equals none."""
    be = dispatch.get_backend(backend, a_keys.device)
    return be.join_probe(a_keys, b_keys, empty_key(key_dtype))


def _gather_rows(state: AggState, idx: torch.Tensor, live: torch.Tensor) -> AggState:
    """Row-gather ``state`` through ``idx``, neutral-filling dead rows."""
    idx = idx.to(torch.int64)

    def pick(col, fill):
        v = col.index_select(0, idx)
        mask = live.reshape((-1,) + (1,) * (v.dim() - 1))
        return torch.where(mask, v, torch.tensor(fill, dtype=v.dtype, device=v.device))

    return AggState(
        keys=pick(state.keys, state.empty),
        count=pick(state.count, 0),
        sum=pick(state.sum, 0.0),
        min=pick(state.min, _INF),
        max=pick(state.max, -_INF),
        key_dtype=state.key_dtype,
    )


def compact_state(state: AggState) -> AggState:
    """Close interior EMPTY gaps with one compaction gather.  A mesh
    relation gathered from its ranks is sorted by (owner, key) but
    EMPTY-padded rank by rank; its valid keys still ascend, so moving them
    to the front restores the one-device layout without a sort."""
    src, live = compact_indices(state.valid())
    return _gather_rows(state, src, live)


def merge_join(a: AggState, b: AggState, *, how: str = "inner",
               backend: str = "auto") -> tuple[AggState, AggState | None]:
    """Merge join of two sorted, duplicate-free, EMPTY-padded states.

    ``how``: ``"inner"`` returns ``(left, right)``, two states of capacity
    ``|a|`` sharing one sorted key vector (matches compacted to the front,
    EMPTY tail), carrying a's and b's planes; ``"semi"`` the left rows with
    a right match and ``"anti"`` those without one (``right`` is None)."""
    if how not in JOIN_HOWS:
        raise ValueError(f"unknown join how={how!r}; expected one of {JOIN_HOWS}")
    if a.key_dtype != b.key_dtype or a.device != b.device:
        raise ValueError(
            f"join of states in different key domains or devices: {a.key_dtype} on "
            f"{a.device} vs {b.key_dtype} on {b.device}")
    if a.capacity == 0:
        return a, (b if how == "inner" else None)
    pos, hit = join_probe(a.keys, b.keys, a.key_dtype, backend=backend)
    keep = (a.valid() & ~hit) if how == "anti" else hit
    src, live = compact_indices(keep)
    left = _gather_rows(a, src, live)
    if how != "inner":
        return left, None
    if b.capacity == 0:
        return left, empty_like(b, a.capacity)
    right = _gather_rows(b, pos.index_select(0, src), live)
    return left, right


def group_join_products(left: AggState, right: AggState) -> dict[str, torch.Tensor]:
    """The aggregation-fused group-join (§2.5, Fig 4) over an inner join's
    aligned sides: per key, ``join_count`` = |L|·|R|, and the cross sums
    ``sum_left_x_count_right`` = Σ_L v·|R| and ``count_left_x_sum_right``
    = |L|·Σ_R w.  float32: the product of two hot groups' counts overflows
    int32."""
    n_l = left.count.to(torch.float32)
    n_r = right.count.to(torch.float32)
    return {
        "join_count": n_l * n_r,
        "sum_left_x_count_right": left.sum * n_r[:, None],
        "count_left_x_sum_right": right.sum * n_l[:, None],
    }

"""Gradient compression on the paper's aggregation engine (counterpart of
:mod:`repro.optim.compression`).

Top-k sparsification with error feedback: each rank keeps the top-k
magnitude entries of (grad + residual), exchanges the sparse (index,
value) pairs, and aggregates them by key.  Duplicate indices across ranks
are the paper's grouping problem, solved with the same one-shot group-by
(:func:`repro_torch.core.sorted_ops.sorted_groupby`: on the card the
argsort and segmented-combine kernels).  The residual keeps compressed SGD
convergent.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sorted_ops
from repro_torch.core.types import empty_key
from repro_torch.distributed import sharding


class TopKState(NamedTuple):
    residual: torch.Tensor  # error-feedback accumulator, float32, shaped like the gradient


def init_topk(grad_like: torch.Tensor) -> TopKState:
    return TopKState(torch.zeros(grad_like.shape, dtype=torch.float32, device=grad_like.device))


def compress_topk(grad: torch.Tensor, state: TopKState, k: int):
    """grad (N,) → ``(idx (k,) int64, val (k,) float32, new_state)``: the k
    entries of largest magnitude of grad + residual, which the new residual
    then holds as zeros."""
    acc = grad.to(torch.float32) + state.residual
    idx = torch.topk(acc.abs(), k, sorted=True).indices
    sel = acc[idx]
    return idx, sel, TopKState(acc.index_fill_(0, idx, 0.0))


def aggregate_sparse(idx: torch.Tensor, val: torch.Tensor, n: int, *,
                     backend: str = "auto") -> torch.Tensor:
    """Sum (index, value) pairs with duplicate indices into a dense (n,)
    float32 vector: the paper's duplicate-key aggregation over u32 keys
    (the sum plane alone; the reference's min and max planes are never
    read)."""
    st = sorted_ops.sorted_groupby(idx.to(torch.int64), val.to(torch.float32)[:, None],
                                   key_dtype=np.uint32, backend=backend, widths=(1, 0, 0))
    keys = torch.where(st.keys == empty_key(np.uint32), n, st.keys)
    dense = torch.zeros((n + 1,), dtype=torch.float32, device=val.device)
    dense[keys] = st.sum[:, 0]  # one row a key; the EMPTY rows land on row n
    return dense[:n]


def allreduce_topk(grad: torch.Tensor, state: TopKState, k: int, mesh: sharding.Mesh):
    """Sparse all-reduce over ``mesh``'s ranks: top-k, an all-gather of the
    pairs, and the sort-based aggregation; every rank gets the dense sum.
    Moves 2k words a rank instead of N.  Returns ``(dense (N,), new_state)``."""
    n = grad.shape[0]
    idx, val, new_state = compress_topk(grad, state, k)
    all_idx = sharding.all_gather(mesh, idx).reshape(-1)
    all_val = sharding.all_gather(mesh, val).reshape(-1)
    return aggregate_sparse(all_idx, all_val, n), new_state

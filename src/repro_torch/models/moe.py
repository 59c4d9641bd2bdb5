"""Mixture-of-experts block with the paper's sort-based grouping as the
dispatch engine (counterpart of :mod:`repro.models.moe`).

Routing tokens to experts is grouping rows (token, k) by key (expert id):

* ``sorted`` — the paper's technique: the rows are key-sorted by expert
  (the backend's stable argsort: the ported sort kernel on the card), each
  expert's contiguous segment is capacity-padded into an ``(E*C, D)``
  block, the grouped FFN runs on it (the backend's grouped matmul: the
  CUDA kernel on the card), and the results are combined per token.
* ``dense`` — one-hot dispatch/combine einsums, the "hash aggregation"
  analogue, with the same grouped FFN over ``C = B*S`` rows per expert.

``sorted_ep`` is served as ``sorted``: the port has no mesh, and the
reference falls back the same way on one device.  Both modes give equal
outputs up to capacity drops.  In training, gradients flow through the
router's softmax and top-k weights, the scatter into the capacity-padded
block, the grouped FFN (on the card the grouped matmul's own backward),
the combine, the shared expert and the load-balance loss; the sort's
permutation carries none.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import dispatch as backends
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import MLP, Dense, dense, mlp, normal, param


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device, gen=None):
        super().__init__()
        m = cfg.moe
        d, e, eff = cfg.d_model, m.num_experts, m.d_ff_expert
        self.router = Dense(d, e, dtype=dtype, device=device, gen=gen)
        self.wi = param(normal(gen, (e, d, eff), 1.0 / (d ** 0.5), dtype, device))
        self.wg = param(normal(gen, (e, d, eff), 1.0 / (d ** 0.5), dtype, device))
        self.wo = param(normal(gen, (e, eff, d), eff ** -0.5, dtype, device))
        self.shared = (MLP(d, eff * m.num_shared_experts, "swiglu", dtype=dtype, device=device,
                           gen=gen) if m.num_shared_experts else None)


def _router(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """(B, S, D) → top-k expert ids (B, S, K), weights (B, S, K) in x's
    dtype, and the float32 router probabilities (B, S, E).  A stable
    descending sort puts the lower expert id first on a tie, as
    ``jax.lax.top_k`` does."""
    m = cfg.moe
    probs = torch.softmax(dense(p.router, x).to(torch.float32), dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[..., :m.top_k], order[..., :m.top_k]
    if m.router_scale:
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return idx, w.to(x.dtype), probs


def _expert_ffn(p: MoE, xs: torch.Tensor, be) -> torch.Tensor:
    """xs (E, C, D) per-expert token blocks → (E, C, D): three grouped
    matmuls."""
    e, c, d = xs.shape
    x2 = xs.reshape(e * c, d)
    h = F.silu(be.grouped_matmul(x2, p.wg, capacity=c)) * be.grouped_matmul(x2, p.wi, capacity=c)
    return be.grouped_matmul(h, p.wo, capacity=c).reshape(e, c, -1)


def _moe_dense_dispatch(p: MoE, cfg: ModelConfig, x, idx, w, be):
    """One-hot einsum dispatch/combine (the baseline)."""
    b, s, d = x.shape
    e = cfg.moe.num_experts
    onehot = F.one_hot(idx, e).to(x.dtype)  # (B, S, K, E)
    disp = (onehot * w[..., None]).sum(2)  # (B, S, E) combined weights per expert
    xs = torch.einsum("bsd,bse->ebsd", x, (disp > 0).to(x.dtype)).reshape(e, b * s, d)
    ys = _expert_ffn(p, xs, be).reshape(e, b, s, d)
    return torch.einsum("ebsd,bse->bsd", ys, disp)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows per expert of the sorted dispatch for ``tokens`` tokens: the
    capacity factor's share, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    cap = int(m.capacity_factor * tokens * m.top_k / m.num_experts)
    return max(8, -(-cap // 8) * 8)


def _moe_sorted_dispatch(p: MoE, cfg: ModelConfig, x, idx, w, be):
    """The paper's sort-based grouping applied to routing.

    1. run generation: a stable key-sort of the (token, k) rows by expert
       id (key ``expert * T + row``), so each expert's rows are contiguous;
    2. capacity-pad each segment to C rows: a row's rank within its
       segment comes from the segment starts; rows ranked C or later are
       dropped (they go to a trash row past the E*C block);
    3. the grouped FFN on (E, C, D);
    4. combine: each kept row's output, weighted, goes back to its token.
       The reference scatter-adds into token rows; here the rows return
       through the inverse permutation to (T, K, D) and are summed over k
       in a fixed order — the same function, without float atomics, so
       the result does not change from run to run.
    """
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    t = b * s * k
    cap = capacity(cfg, b * s)
    dev = x.device
    rows = torch.arange(t, device=dev)
    flat_x = x.reshape(b * s, d)
    flat_e = idx.reshape(t)
    order = be.argsort(flat_e * t + rows).to(torch.int64)
    se, stok, sw = flat_e[order], order // k, w.reshape(t)[order]
    seg_start = torch.searchsorted(se, torch.arange(e, device=dev))
    rank = rows - seg_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)
    xs = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    xs[slot] = flat_x[stok]
    ys = _expert_ffn(p, xs[:-1].reshape(e, cap, d), be).reshape(e * cap, d)
    contrib = ys[slot.clamp(max=e * cap - 1)] * sw[:, None]
    contrib = torch.where(keep[:, None], contrib, torch.zeros((), dtype=x.dtype, device=dev))
    inv = torch.empty_like(order)
    inv[order] = rows
    per_tok = contrib[inv].reshape(b * s, k, d)
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out.reshape(b, s, d)


def moe_block(p: MoE, cfg: ModelConfig, x: torch.Tensor, *, dispatch: str | None = None,
              backend: str | None = "auto"):
    """Returns ``(y, aux)``: the block's output and the load-balance
    auxiliary loss (float32 scalar).  ``backend``: ``"auto"`` (by x's
    device), ``"torch"`` (the plain versions) or ``"cuda"`` (the
    kernels)."""
    m = cfg.moe
    mode = dispatch or m.dispatch
    if mode == "sorted_ep":
        mode = "sorted"  # one device: the same math, no expert parallelism
    if mode not in ("sorted", "dense"):
        raise ValueError(f"unknown MoE dispatch {mode!r}")
    be = backends.get_backend(backend, x.device)
    idx, w, probs = _router(p, cfg, x)
    if mode == "sorted":
        y = _moe_sorted_dispatch(p, cfg, x, idx, w, be)
    else:
        y = _moe_dense_dispatch(p, cfg, x, idx, w, be)
    if p.shared is not None:
        y = y + mlp(p.shared, x, "swiglu")
    me = probs.mean(dim=(0, 1))
    frac = F.one_hot(idx, m.num_experts).to(torch.float32).mean(dim=(0, 1, 2))
    aux = m.num_experts * torch.sum(me * frac)
    return y, aux

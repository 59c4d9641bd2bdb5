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

``sorted_ep`` is expert parallelism over a mesh of ranks
(:mod:`repro_torch.distributed.moe_parallel`): it runs where the config
names mesh axes (``cfg.mesh_axes``) and a mesh with a ``"model"`` axis is
registered (``moe_parallel.set_current_mesh``); otherwise it is served as
``sorted``, as the reference falls back on one device.  A layer built for
a mesh holds only its rank's slice of the experts (``MoE(experts=)``) and
runs only that way.  The modes give equal outputs up to capacity drops.  In training, gradients flow through the
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
    """The router ``(D, E)``, the experts' ``wi``/``wg`` ``(E, D, F)`` and
    ``wo`` ``(E, F, D)``, and the shared expert.  ``experts=(lo, hi)`` keeps
    only experts ``lo..hi-1`` and those router columns (an expert-parallel
    rank's slice): the draw from ``gen`` is the whole model's, one tensor
    at a time, so a rank's weights are the slices of one process's."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, gen=None, experts=None):
        super().__init__()
        m = cfg.moe
        d, e, eff = cfg.d_model, m.num_experts, m.d_ff_expert
        lo, hi = experts or (0, e)

        def experts_of(shape, scale, axes):
            if gen is None:
                return param(normal(None, (hi - lo,) + shape, scale, dtype, device), axes)
            return param(normal(gen, (e,) + shape, scale, dtype, device)[lo:hi].clone(), axes)

        self.router = Dense(d, e, dtype=dtype, device=device, gen=gen, axes=("embed", "expert"))
        if (lo, hi) != (0, e):
            self.router.kernel = param(self.router.kernel[:, lo:hi].contiguous(),
                                       self.router.kernel.axes)
        self.wi = experts_of((d, eff), 1.0 / (d ** 0.5), ("expert", "embed", "mlp"))
        self.wg = experts_of((d, eff), 1.0 / (d ** 0.5), ("expert", "embed", "mlp"))
        self.wo = experts_of((eff, d), eff ** -0.5, ("expert", "mlp", "embed"))
        self.shared = (MLP(d, eff * m.num_shared_experts, "swiglu", dtype=dtype, device=device,
                           gen=gen) if m.num_shared_experts else None)


def _router(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """(B, S, D) → top-k expert ids (B, S, K), weights (B, S, K) in x's
    dtype, and the float32 router probabilities (B, S, E)."""
    return _route(dense(p.router, x).to(torch.float32), cfg, x.dtype)


def _route(logits: torch.Tensor, cfg: ModelConfig, dtype: torch.dtype):
    """:func:`_router` from the float32 router logits (B, S, E).  A stable
    descending sort puts the lower expert id first on a tie, as
    ``jax.lax.top_k`` does."""
    m = cfg.moe
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = vals[..., :m.top_k], order[..., :m.top_k]
    if m.router_scale:
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    return idx, w.to(dtype), probs


def load_balance(probs: torch.Tensor, idx: torch.Tensor, e: int, mesh=None) -> torch.Tensor:
    """The load-balance auxiliary loss of router probabilities (B, S, E)
    and top-k ids (B, S, K): ``E * sum(mean prob * mean assignment)``.  On
    the data ranks of ``mesh`` (each with its shard of the batch) the means
    are the global batch's, as GSPMD computes them: the value is the
    global loss on every rank, its gradient this shard's part of it."""
    if mesh is None or mesh.world == 1:
        me = probs.mean(dim=(0, 1))
        frac = F.one_hot(idx, e).to(torch.float32).mean(dim=(0, 1, 2))
        return e * torch.sum(me * frac)
    from repro_torch.distributed import sharding

    n = torch.tensor([probs.shape[0] * probs.shape[1]], dtype=torch.float32,
                     device=probs.device)
    counts = F.one_hot(idx, e).to(torch.float32).sum(dim=(0, 1, 2))
    tot = sharding.all_reduce(mesh, torch.cat([counts, n]), "sum")
    frac = tot[:-1] / (tot[-1] * idx.shape[-1])
    local = e * torch.sum(probs.sum(dim=(0, 1)) / tot[-1] * frac)
    total = sharding.all_reduce(mesh, local.detach(), "sum")
    return local + (total - local.detach())


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
        from repro_torch.distributed import moe_parallel as MP

        if cfg.mesh_axes is not None and MP.registered_ep_mesh() is not None:
            return MP.ep_moe_block(p, cfg, x, backend=backend)
        mode = "sorted"  # one device: the same math, no expert parallelism
    if mode not in ("sorted", "dense"):
        raise ValueError(f"unknown MoE dispatch {mode!r}")
    if p.wi.shape[0] != m.num_experts:
        raise ValueError(f"this MoE layer holds {p.wi.shape[0]} of {m.num_experts} experts "
                         "(a rank's slice): it runs only as sorted_ep on a registered mesh")
    be = backends.get_backend(backend, x.device)
    idx, w, probs = _router(p, cfg, x)
    if mode == "sorted":
        y = _moe_sorted_dispatch(p, cfg, x, idx, w, be)
    else:
        y = _moe_dense_dispatch(p, cfg, x, idx, w, be)
    if p.shared is not None:
        y = y + mlp(p.shared, x, "swiglu")
    return y, load_balance(probs, idx, m.num_experts, getattr(p, "dp_mesh", None))

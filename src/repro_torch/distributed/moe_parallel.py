"""Expert-parallel MoE dispatch over a mesh of ranks: the paper's sort-based
grouping as the routing engine across ranks (counterpart of
:mod:`repro.distributed.moe_parallel`).

On a data × model mesh (:func:`repro_torch.distributed.sharding.make_mesh`)
each rank holds its data shard of the tokens, replicated over ``"model"``,
and its model coordinate's slice of the experts (``E_loc = E / ep``
experts, ``ep`` the size of ``"model"``).  Per rank, as the reference:

1. run generation (§3): the (token, k) rows of a chunk of tokens are
   key-sorted by expert id (the backend's stable argsort: the ported sort
   kernel on the card) into contiguous segments, each capacity-clamped to
   C rows (overflow rows drop);
2. partition ≡ sort (§2.1): the sorted, capacity-padded ``(E*C, D)``
   layout reshapes directly into the all-to-all's send buffer ``(ep,
   E_loc*C, D)``;
3. the all-to-all over ``"model"``: each rank receives its experts' rows
   from every model rank;
4. the grouped FFN on ``(E_loc, ep*C, D)`` (the backend's grouped matmul:
   the CUDA kernel on the card, with its own backward);
5. the all-to-all back and the combine per token.  The reference
   scatter-adds; here the rows return through the inverse permutation and
   are summed over k in a fixed order, as the port's ``sorted`` dispatch
   does (no float atomics).

The router's columns are sharded like the experts: each rank computes its
columns' logits, which are all-gathered over ``"model"``.  The load-balance
loss is each data shard's own, averaged over the data axes.  Every rank of
a model group dispatches the same tokens (the reference's layout: ``x`` is
replicated over ``"model"``), so each expert runs on ``ep`` copies of its
rows.  Gradients follow the reference's ``shard_map`` convention
(:mod:`.sharding`): the block's output is one value over ``"model"``, the
experts' and router's gradients are summed over the data axes, ``dx`` over
``"model"``; parameters outside the block (the shared expert, the rest of
the model) keep the gradient of the rank's data shard.  In a sharded model
(:mod:`.fsdp`) the block gets its expert slice gathered over the data
axes, and those gathers' backwards do the data axes' sum.  With gradients on,
each chunk is rematerialized (``torch.utils.checkpoint``); the recompute
runs the chunk's collectives again, in the same order on every rank.
"""
from __future__ import annotations

import types

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import dispatch as backends
from repro_torch.distributed import sharding
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp

EP_AXIS = "model"
DATA_AXES = ("pod", "data")


def _local_sorted_dispatch(xc: torch.Tensor, er: torch.Tensor, e: int, cap: int, k: int, be):
    """Sort-based grouping of a chunk's rows by expert id (paper §3).

    ``xc`` (T, D) tokens, ``er`` (T*k,) the expert of each (token, k) row.
    Returns ``(order, slot, keep, xs)``: the rows' stable sort by expert,
    each sorted row's place in the capacity-padded ``(E*C, D)`` block ``xs``
    (``E*C``, a trash row past it, for a dropped row) and whether it was
    kept."""
    t = er.shape[0]
    dev = xc.device
    rows = torch.arange(t, device=dev)
    order = be.argsort(er * t + rows).to(torch.int64)
    se = er[order]
    seg_start = torch.searchsorted(se, torch.arange(e, device=dev))
    rank = rows - seg_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)
    xs = torch.zeros((e * cap + 1, xc.shape[1]), dtype=xc.dtype, device=dev)
    xs[slot] = xc[order // k]
    return order, slot, keep, xs[:-1]


def chunking(cfg: ModelConfig, tokens: int) -> tuple[int, int, int]:
    """``(chunk, n_chunks, cap)`` of ``tokens`` local tokens: chunks of
    ``min(cfg.moe_chunk, tokens)`` tokens and the per-chunk capacity, as
    the reference's.  Raises where its reshape into chunks fails."""
    m = cfg.moe
    chunk = min(cfg.moe_chunk, tokens)
    if chunk < 1 or tokens % chunk:
        raise ValueError(f"{tokens} tokens do not split into chunks of {chunk} "
                         f"(moe_chunk {cfg.moe_chunk})")
    cap = max(8, int(m.capacity_factor * chunk * m.top_k / m.num_experts + 7) // 8 * 8)
    return chunk, tokens // chunk, cap


def make_ep_moe(mesh, dp_axes: tuple, ep_axis: str = EP_AXIS):
    """Returns ``moe_fn(p, x, cfg, backend)`` -> ``(y, aux)``: the sorted
    expert-parallel dispatch on this rank of ``mesh``.  ``x`` (b, S, D) is
    the rank's data shard over ``dp_axes``; ``p`` holds the rank's expert
    slice (``wi``/``wg`` (E_loc, D, F), ``wo`` (E_loc, F, D), the router's
    (D, E_loc) columns).  Differentiable (module docstring)."""
    ep_mesh = mesh.sub(ep_axis)
    dp_mesh = mesh.sub(dp_axes)
    ep = ep_mesh.world
    others = tuple(a for a in mesh.axis_names if a != ep_axis)
    x_rep = mesh.sub(tuple(a for a in mesh.axis_names if a not in dp_axes))
    everyone = mesh.sub(mesh.axis_names)

    def local_fn(p, x: torch.Tensor, cfg: ModelConfig, backend="auto"):
        m = cfg.moe
        e, k = m.num_experts, m.top_k
        if e % ep or p.wi.shape[0] != e // ep:
            raise ValueError(f"{e} experts over {ep} model ranks: the layer holds "
                             f"{p.wi.shape[0]} (expected {e // ep})")
        e_loc = e // ep
        b, s, d = x.shape
        be = backends.get_backend(backend, x.device)
        grad = torch.is_grad_enabled()
        if grad and not getattr(p, "gathered", False):
            # the shard_map boundary: inputs replicated over axes they are not split on
            p_rep = mesh.sub(others)
            x = sharding.replicated_input(x_rep, x)
            w = {n: sharding.replicated_input(p_rep, getattr(p, n))
                 for n in ("wi", "wg", "wo")}
            router = sharding.replicated_input(p_rep, p.router.kernel)
        elif grad:  # a sharded model's weights: their gathers sum the data ranks' gradients
            x = sharding.replicated_input(x_rep, x)
            w = {n: getattr(p, n) for n in ("wi", "wg", "wo")}
            router = p.router.kernel
        else:
            w = {n: getattr(p, n) for n in ("wi", "wg", "wo")}
            router = p.router.kernel
        experts = types.SimpleNamespace(**w)
        logits = (x @ router).to(torch.float32)  # this rank's columns
        logits = sharding.all_gather_tiled(ep_mesh, logits, dim=2)
        idx, wts, probs = MOE._route(logits, cfg, x.dtype)
        aux = sharding.pmean(dp_mesh, MOE.load_balance(probs, idx, e))

        tokens = b * s
        chunk, n_chunks, cap = chunking(cfg, tokens)
        x_flat = x.reshape(tokens, d)
        eidx = idx.reshape(tokens, k)
        wflat = wts.reshape(tokens, k)

        def chunk_step(xc, ec, wc):
            t = chunk * k
            order, slot, keep, xs = _local_sorted_dispatch(xc, ec.reshape(t), e, cap, k, be)
            # the sorted layout is the range partition: a reshape is the send buffer
            recv = sharding.all_to_all_blocks(ep_mesh, xs.reshape(ep, e_loc * cap, d))
            xs_loc = (recv.reshape(ep, e_loc, cap, d).transpose(0, 1)
                      .reshape(e_loc, ep * cap, d))
            ys_loc = MOE._expert_ffn(experts, xs_loc, be)
            back = (ys_loc.reshape(e_loc, ep, cap, d).transpose(0, 1)
                    .reshape(ep, e_loc * cap, d))
            ys = sharding.all_to_all_blocks(ep_mesh, back).reshape(e * cap, d)
            # combine: each kept row, weighted, back to its token; summed over k in order
            contrib = ys[slot.clamp(max=e * cap - 1)] * wc.reshape(t)[order][:, None]
            contrib = torch.where(keep[:, None], contrib,
                                  torch.zeros((), dtype=contrib.dtype, device=contrib.device))
            inv = torch.empty_like(order)
            inv[order] = torch.arange(t, device=order.device)
            per_tok = contrib[inv].reshape(chunk, k, d)
            out = per_tok[:, 0]
            for j in range(1, k):
                out = out + per_tok[:, j]
            return out

        remat = grad and (x.requires_grad or any(t.requires_grad for t in w.values())
                          or router.requires_grad)
        outs = []
        for c in range(n_chunks):
            args = tuple(a[c * chunk:(c + 1) * chunk] for a in (x_flat, eidx, wflat))
            outs.append(checkpoint(chunk_step, *args, use_reentrant=False,
                                   preserve_rng_state=False) if remat else chunk_step(*args))
        y = torch.cat(outs).reshape(b, s, d)
        if grad:  # outputs: y replicated over the axes x was, aux over every axis
            y = sharding.replicated_output(x_rep, y)
            aux = sharding.replicated_output(everyone, aux)
        return y, aux

    return local_fn


_CURRENT_MESH = [None]


def set_current_mesh(mesh) -> None:
    """Register the mesh the ``sorted_ep`` dispatch runs on (None: none)."""
    _CURRENT_MESH[0] = mesh


def registered_ep_mesh():
    """The registered mesh if it has a ``"model"`` axis, else None."""
    mesh = _CURRENT_MESH[0]
    return mesh if mesh is not None and EP_AXIS in mesh.axis_names else None


def _check_mesh(mesh) -> None:
    if mesh is None:
        raise RuntimeError("no mesh: call set_current_mesh(mesh) before the sorted_ep dispatch")
    if EP_AXIS not in mesh.axis_names:
        raise ValueError(f"the sorted_ep dispatch needs a mesh with a {EP_AXIS!r} axis; "
                         f"axes: {mesh.axis_names}")


def data_axes(cfg: ModelConfig, mesh) -> tuple:
    """The data-parallel axes (the reference's ``("pod", "data")`` that the
    config names); each must be an axis of ``mesh``."""
    dp = tuple(a for a in DATA_AXES if a in (cfg.mesh_axes or ()))
    if not dp or any(a not in mesh.axis_names for a in dp):
        raise ValueError(f"config mesh axes {cfg.mesh_axes} name no data axis of the mesh "
                         f"{mesh.axis_names}")
    return dp


def expert_slice(cfg: ModelConfig, mesh) -> tuple[int, int]:
    """Experts ``[j*E_loc, (j+1)*E_loc)`` held by the rank at model
    coordinate j (the reference's ``P("model")`` of the expert weights)."""
    _check_mesh(mesh)
    ep, e = mesh.shape[EP_AXIS], cfg.moe.num_experts
    if e % ep:
        raise ValueError(f"{e} experts do not split over {ep} model ranks")
    j = mesh.coords[EP_AXIS]
    return j * (e // ep), (j + 1) * (e // ep)


def ep_moe_block(p, cfg: ModelConfig, x: torch.Tensor, mesh=None, *, backend="auto"):
    """The ``sorted_ep`` MoE block on this rank: ``x`` (b, S, D) is the
    rank's data shard, ``p`` its :class:`repro_torch.models.moe.MoE` slice.
    Returns ``(y, aux)`` as ``moe_block`` does.  Raises without a mesh (the
    argument or the registered one) or on a mesh without ``"model"``."""
    mesh = mesh or _CURRENT_MESH[0]
    _check_mesh(mesh)
    y, aux = make_ep_moe(mesh, data_axes(cfg, mesh))(p, x, cfg, backend)
    if p.shared is not None:
        y = y + mlp(p.shared, x, "swiglu")
    return y, aux

"""Transformer and Mamba blocks and the layer stack of the port
(counterpart of :mod:`repro.models.transformer`).

A block is ``attn_moe`` (attention + MoE), ``attn_mlp`` (attention + MLP)
or ``mamba`` (a Mamba2 mixer), pre-norm with residuals; its attention is
MLA when the config has one.  The stack is an ``nn.ModuleList`` looped in
Python (eager: no scan).  Where ``cfg.remat`` is set and gradients are on
(training), each block is rematerialized: its activations are
recomputed in the backward pass, as the reference's ``jax.checkpoint`` of
its scan body.  The recompute routes the MoE tokens again; the backend's
stable argsort gives them the same order.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

KINDS = ("attn_moe", "attn_mlp", "mamba")


class Block(nn.Module):
    """``experts``: an expert-parallel rank's slice of an ``attn_moe``
    block's experts (:class:`repro_torch.models.moe.MoE`)."""

    def __init__(self, cfg: ModelConfig, kind: str, *, dtype, device, gen=None, experts=None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}; one of {KINDS}")
        self.kind = kind
        kw = dict(dtype=dtype, device=device)
        if kind == "mamba":
            self.norm = L.Norm(cfg.d_model, **kw)
            self.mixer = SSM.Mamba2(cfg, gen=gen, **kw)
            return
        self.ln1 = L.Norm(cfg.d_model, **kw)
        self.ln2 = L.Norm(cfg.d_model, **kw)
        self.attn = (L.MLA(cfg, gen=gen, **kw) if cfg.mla is not None
                     else L.Attention(cfg, gen=gen, **kw))
        if kind == "attn_moe":
            self.moe = MOE.MoE(cfg, gen=gen, experts=experts, **kw)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, gen=gen, **kw)


def apply_block(p: Block, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, mrope_pos=None, dispatch=None, backend="auto", mesh=None):
    """Returns ``(x, new_cache, aux)``.  ``mesh``: the mesh of ranks whose
    shard of the cache ``cache`` is (``model.init_cache(..., mesh=)``)."""
    if p.kind == "mamba":
        h, new_cache = SSM.mamba2_block(p.mixer, cfg, L.rmsnorm(p.norm, x, cfg.norm_eps),
                                        cache=cache, mesh=mesh)
        return x + h, new_cache, torch.zeros((), dtype=torch.float32, device=x.device)
    hn = L.rmsnorm(p.ln1, x, cfg.norm_eps)
    if cfg.mla is not None:
        h, new_cache = L.mla_attention(p.attn, cfg, hn, positions, cache=cache, mesh=mesh)
    else:
        h, new_cache = L.attention(p.attn, cfg, hn, positions, cache=cache,
                                   mrope_pos=mrope_pos, mesh=mesh)
    x = x + h
    hn = L.rmsnorm(p.ln2, x, cfg.norm_eps)
    if p.kind == "attn_moe":
        h, aux = MOE.moe_block(p.moe, cfg, hn, dispatch=dispatch, backend=backend)
    else:
        h, aux = L.mlp(p.mlp, hn, cfg.act), torch.zeros((), dtype=torch.float32,
                                                         device=x.device)
    return x + h, new_cache, aux


def layer_cache(caches: dict, i: int) -> dict:
    """Row ``i`` of caches stacked over layers: views of its tensors."""
    return {k: v[i] for k, v in caches.items()}


def restack(caches: dict, olds: list[dict], news: list[dict]) -> dict:
    """The stacked caches after each layer ``i`` turned ``olds[i]`` (views
    of ``caches``' rows) into ``news[i]``: a field every layer wrote in place
    (returned the very view it was given) is ``caches``' own tensor;
    another field, the layers' new tensors stacked."""
    out = {}
    for f, stacked in caches.items():
        if all(new[f] is old[f] for old, new in zip(olds, news)):
            out[f] = stacked
        else:
            out[f] = torch.stack([new[f] for new in news])
    return out


def remat_on(cfg: ModelConfig, x: torch.Tensor, module: nn.Module, caches=None) -> bool:
    """Whether a forward rematerializes ``module``'s blocks: ``cfg.remat``,
    no caches, and a gradient to take (gradients on, and x or one of the
    module's parameters requiring one), as in training."""
    return (cfg.remat and caches is None and torch.is_grad_enabled()
            and (x.requires_grad or any(t.requires_grad for t in module.parameters())))


def rematerialized(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def apply_stack(blocks: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, caches=None, mrope_pos=None, dispatch=None,
                backend="auto", full=None, mesh=None):
    """Apply the blocks in order.  ``caches``: None, or the stack's caches
    stacked over layers: attention's ``{"k", "v", "index"}`` (k/v ``(L, B,
    Smax, KH, Dh)``) or MLA's ``{"latent", "k_rope", "index"}``, whose rows
    the layers write in place, with ``index`` ``(L,)`` on the host; or
    Mamba's ``{"conv", "ssm"}``, whose layers return new tensors.  Returns
    ``(x, new_caches, aux)``.  Rematerializes each block where
    :func:`remat_on`.  ``full``: a sharded model's ``fn(block) -> view``
    (:func:`repro_torch.distributed.fsdp.block_view`), applied where the
    block runs (inside the rematerialized function: the recompute gathers
    the block's weights again).  ``mesh``: the caches are the rank's shards
    on it (:func:`apply_block`)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    full = full or (lambda blk: blk)
    if remat_on(cfg, x, blocks, caches):
        for blk in blocks:
            def run(h, blk=blk):
                out, _, a = apply_block(full(blk), cfg, h, positions, mrope_pos=mrope_pos,
                                        dispatch=dispatch, backend=backend)
                return out, a

            x, a = rematerialized(run, x)
            aux = aux + a
        return x, None, aux
    olds, news = [], []
    for i, blk in enumerate(blocks):
        cache = None if caches is None else layer_cache(caches, i)
        x, nc, a = apply_block(full(blk), cfg, x, positions, cache=cache, mrope_pos=mrope_pos,
                               dispatch=dispatch, backend=backend, mesh=mesh)
        aux = aux + a
        olds.append(cache)
        news.append(nc)
    if caches is None:
        return x, None, aux
    return x, restack(caches, olds, news), aux

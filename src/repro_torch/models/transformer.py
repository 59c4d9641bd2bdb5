"""Transformer blocks and the layer stack of the port (counterpart of
:mod:`repro.models.transformer`).

A block is ``attn_moe`` (attention + MoE) or ``attn_mlp`` (attention +
MLP), pre-norm with residuals.  The stack is an ``nn.ModuleList`` looped
in Python: serving runs eagerly, so there is no scan and no remat.
Mamba blocks are not ported (ROADMAP Queue 1 item 3c).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, *, dtype, device, gen=None):
        super().__init__()
        if kind not in ("attn_moe", "attn_mlp"):
            raise NotImplementedError(f"block kind {kind!r} is not ported yet "
                                      "(ROADMAP Queue 1 item 3c)")
        self.kind = kind
        kw = dict(dtype=dtype, device=device)
        self.ln1 = L.Norm(cfg.d_model, **kw)
        self.ln2 = L.Norm(cfg.d_model, **kw)
        self.attn = L.Attention(cfg, gen=gen, **kw)
        if kind == "attn_moe":
            self.moe = MOE.MoE(cfg, gen=gen, **kw)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, gen=gen, **kw)


def apply_block(p: Block, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
                cache=None, dispatch=None, backend="auto"):
    """Returns ``(x, new_cache, aux)``."""
    h, new_cache = L.attention(p.attn, cfg, L.rmsnorm(p.ln1, x, cfg.norm_eps), positions,
                               cache=cache)
    x = x + h
    hn = L.rmsnorm(p.ln2, x, cfg.norm_eps)
    if p.kind == "attn_moe":
        h, aux = MOE.moe_block(p.moe, cfg, hn, dispatch=dispatch, backend=backend)
    else:
        h, aux = L.mlp(p.mlp, hn, cfg.act), torch.zeros((), dtype=torch.float32,
                                                         device=x.device)
    return x + h, new_cache, aux


def apply_stack(blocks: nn.ModuleList, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, *, caches=None, dispatch=None, backend="auto"):
    """Apply the blocks in order.  ``caches``: None, or the stacked
    ``{"k", "v", "index"}`` of the whole stack (k/v ``(L, B, Smax, KH,
    Dh)``, index ``(L,)`` on the host); layer i works on views of row i, so
    K/V are written in place.  Returns ``(x, new_caches, aux)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_index = []
    for i, blk in enumerate(blocks):
        cache = None if caches is None else {
            "k": caches["k"][i], "v": caches["v"][i], "index": caches["index"][i]}
        x, nc, a = apply_block(blk, cfg, x, positions, cache=cache, dispatch=dispatch,
                               backend=backend)
        aux = aux + a
        if nc is not None:
            new_index.append(nc["index"])
    if caches is None:
        return x, None, aux
    return x, {"k": caches["k"], "v": caches["v"], "index": torch.stack(new_index)}, aux

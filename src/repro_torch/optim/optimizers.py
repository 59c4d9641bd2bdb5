"""Optimisers of the port, written out (counterpart of
:mod:`repro.optim.optimizers`; not ``torch.optim``, whose update rules
differ).

* ``adamw``     — the default.
* ``adafactor`` — a factored second moment (row and column means) and no
  first moment, with update clipping; the reference's memory plan for its
  largest models.

Both are plain functions over dicts of leaves with an explicit step: a
leaf is a tensor, or a tuple of equally shaped tensors standing for their
stack (a model's layer stack, :func:`repro_torch.models.model.param_leaves`),
so that each moment has the reference's shape.  ``init(params)`` gives an
:class:`OptState`; ``update(grads, state, params)`` writes the new
parameters and moments into their tensors (no copy of the model's state)
and returns ``(params, new_state)``.  Arithmetic is float32 throughout, and
the parameters are cast back to their dtype once, as the reference's.

On a mesh (a sharded model, :mod:`repro_torch.distributed.fsdp`) each rank
holds its shard of every leaf and of its moments; ``layout`` (a
``fsdp.LeafLayout``) gives the optimisers the leaves' specs and global
shapes.  AdamW is elementwise and runs on the shards as they are (the
padding of an uneven shard stays zero).  The global norm sums each leaf's
squares once over the mesh however many ranks hold a copy, and
Adafactor's row and column means, its rows' mean and its update's RMS
over a split dimension are sums over that dimension's ranks, taken on the
shard's rows and columns that hold the leaf: the update is the
reference's.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class OptState(NamedTuple):
    step: int  # updates made (a host integer)
    m: dict  # first moment (adamw) or factored rows (adafactor), by leaf path
    v: dict  # second moment (adamw) or factored columns (adafactor)


def parts(leaf) -> tuple:
    """A leaf's tensors: the stack's layers, or the tensor alone."""
    return leaf if isinstance(leaf, tuple) else (leaf,)


def leaf_shape(leaf) -> tuple:
    return ((len(leaf),) + tuple(leaf[0].shape) if isinstance(leaf, tuple)
            else tuple(leaf.shape))


def whole(leaf) -> torch.Tensor:
    """The leaf as one tensor (a stack is copied into one)."""
    return torch.stack(leaf) if isinstance(leaf, tuple) else leaf


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable[[int], float]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``."""
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(1, warmup)
        t = min(max((step - warmup) / max(1, total - warmup), 0.0), 1.0)
        return 0.5 * base_lr * (1.0 + math.cos(math.pi * t))

    return lr


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float, layout=None):
    """Scale every gradient by ``min(1, max_norm / norm)``, the norm taken in
    float32 over all leaves (in their order), in place; returns ``(grads,
    norm)`` with the norm a float32 scalar tensor (no host sync).  With a
    ``layout`` the gradients are shards: each leaf's squares are divided by
    the ranks holding a copy of its blocks and summed over the mesh in one
    all-reduce."""
    tensors = [g for leaf in grads.values() for g in parts(leaf)]
    if layout is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in tensors))
    else:
        local = torch.stack([sum(torch.sum(torch.square(g.to(torch.float32)))
                                 for g in parts(leaf)) / layout.copies(k)
                             for k, leaf in grads.items()])
        gn = torch.sqrt(layout.total_of(local).sum())
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-9), max=1.0)
    for g in tensors:
        g.copy_((g.to(torch.float32) * scale).to(g.dtype))
    return grads, gn


def _zeros(shape, leaf, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=parts(leaf)[0].device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, moment_dtype=torch.float32):
    lr_fn = lr if callable(lr) else (lambda s: lr)

    def init(params: dict) -> OptState:
        return OptState(0, {k: _zeros(leaf_shape(p), p, moment_dtype) for k, p in params.items()},
                        {k: _zeros(leaf_shape(p), p, moment_dtype) for k, p in params.items()})

    @torch.no_grad()
    def update(grads: dict, state: OptState, params: dict):
        step = state.step + 1
        lr_t = lr_fn(step)
        bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        for k, leaf in params.items():
            # elementwise: a stack's layers update one at a time, on rows of its moments
            for i, (p, g) in enumerate(zip(parts(leaf), parts(grads[k]))):
                m, v = state.m[k], state.v[k]
                if isinstance(leaf, tuple):
                    m, v = m[i], v[i]
                g = g.to(torch.float32)
                m_new = b1 * m.to(torch.float32) + (1 - b1) * g
                v_new = b2 * v.to(torch.float32) + (1 - b2) * g * g
                delta = ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                         + weight_decay * p.to(torch.float32))
                m.copy_(m_new)
                v.copy_(v_new)
                del m_new, v_new
                p.copy_((p.to(torch.float32) - lr_t * delta).to(p.dtype))
        return params, OptState(step, state.m, state.v)

    return init, update


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_threshold=1.0, weight_decay=0.0,
              layout=None):
    lr_fn = lr if callable(lr) else (lambda s: lr)

    def init(params: dict) -> OptState:
        rows, cols = {}, {}
        for k, p in params.items():
            shape = leaf_shape(p)
            if len(shape) < 2:
                rows[k], cols[k] = _zeros(shape, p, torch.float32), _zeros((1,), p, torch.float32)
            else:
                rows[k] = _zeros(shape[:-1], p, torch.float32)
                cols[k] = _zeros(shape[:-2] + shape[-1:], p, torch.float32)
        return OptState(0, rows, cols)

    @torch.no_grad()
    def update(grads: dict, state: OptState, params: dict):
        step = state.step + 1
        beta = 1.0 - (step + 1.0) ** (-decay)
        lr_t = lr_fn(step)
        for k, leaf in params.items():
            if layout is not None:
                _sharded_leaf(k, leaf, grads[k], state.m[k], state.v[k], beta, lr_t)
                continue
            # the leaf whole: a stack's moments and its update clipping span its layers
            p, g = whole(leaf), whole(grads[k]).to(torch.float32)
            vr, vc = state.m[k], state.v[k]
            g2 = g * g + eps
            if p.dim() < 2:
                vr_new = beta * vr + (1 - beta) * g2
                u = g * torch.rsqrt(vr_new)
                vc_new = vc
            else:
                vr_new = beta * vr + (1 - beta) * g2.mean(-1)
                vc_new = beta * vc + (1 - beta) * g2.mean(-2)
                denom = vr_new[..., None] * vc_new[..., None, :]
                denom = denom / torch.clamp_min(vr_new.mean(-1)[..., None, None], eps)
                u = g * torch.rsqrt(denom + eps)
            rms = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            delta = u + weight_decay * p.to(torch.float32)
            new = (p.to(torch.float32) - lr_t * delta).to(p.dtype)
            for i, t in enumerate(parts(leaf)):
                t.copy_(new[i] if isinstance(leaf, tuple) else new)
            vr.copy_(vr_new)
            vc.copy_(vc_new)
        return params, OptState(step, state.m, state.v)

    def _sharded_leaf(k, leaf, grad, vr, vc, beta, lr_t):
        """One leaf's update on this rank's shard: a mean over a split
        dimension is a sum over its ranks (``layout.psum``) over the global
        length, on the rows and columns that hold the leaf."""
        lay = layout
        valid = lay.valid(k)
        p, g = whole(leaf)[valid], whole(grad)[valid].to(torch.float32)
        g2 = g * g + eps
        nd = p.dim()
        if nd < 2:
            vr_new = beta * vr[valid] + (1 - beta) * g2
            u = g * torch.rsqrt(vr_new)
        else:
            rows, cols = vr[valid[:-1]], vc[valid[:-2] + valid[-1:]]
            vr_new = beta * rows + (1 - beta) * lay.psum(g2.sum(-1), k, nd - 1) / lay.size(k, -1)
            vc_new = beta * cols + (1 - beta) * lay.psum(g2.sum(-2), k, nd - 2) / lay.size(k, -2)
            vr_mean = lay.psum(vr_new.sum(-1), k, nd - 2) / lay.size(k, -2)
            denom = vr_new[..., None] * vc_new[..., None, :]
            denom = denom / torch.clamp_min(vr_mean[..., None, None], eps)
            u = g * torch.rsqrt(denom + eps)
        rms = torch.sqrt(lay.psum_all(torch.sum(u * u), k) / math.prod(lay.shapes[k]) + 1e-12)
        u = u / torch.clamp_min(rms / clip_threshold, 1.0)
        delta = u + weight_decay * p.to(torch.float32)
        new = (p.to(torch.float32) - lr_t * delta).to(p.dtype)
        for i, t in enumerate(parts(leaf)):
            if isinstance(leaf, tuple):
                t[valid[1:]] = new[i]
            else:
                t[valid] = new
        if nd < 2:
            vr[valid] = vr_new
        else:
            vr[valid[:-1]] = vr_new
            vc[valid[:-2] + valid[-1:]] = vc_new

    return init, update


def make_optimizer(name: str, lr, layout=None, **kw):
    """``(init, update)`` of ``name``; ``layout``: a sharded model's leaves
    (AdamW, elementwise, needs none)."""
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, layout=layout, **kw)
    raise ValueError(f"unknown optimizer {name!r}; adamw or adafactor")

"""Step builders of the port (counterpart of :mod:`repro.launch.steps`).

``train_step``  : forward + loss + backward + optimizer update.
``prefill_step``: forward over the whole prompt, building the decode cache.
``serve_step``  : one-token decode against the cache.

All run eagerly on the model's device and take the reference's batch
dicts: ``tokens`` (B, S) ids or a front-end stub's (B, S, D) embeddings,
``labels`` (B, S), ``token`` (B, 1) and ``caches`` (any family's, pairs
passed through as they are), and ``mrope_pos`` (3, B, S) for an ``mrope``
model.  ``backend`` picks the MoE block's sort and grouped matmul
(``"auto"``: by device; ``"torch"``: the plain versions; ``"cuda"``: the
kernels, the grouped matmul's backward included).  The reference's
dry-run helpers (``input_specs``, ``abstract_train_state``,
``state_shardings``, ``batch_shardings``) are not ported (ROADMAP Queue 1
item 3f).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import (
    OptState,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)


class TrainState(NamedTuple):
    """The model (its parameters, gradients on), the optimizer's moments
    by leaf path (:func:`repro_torch.models.model.param_leaves`) and the
    updates made so far (a host integer)."""

    params: M.Model
    opt_m: dict
    opt_v: dict
    step: int

# the reference's four input-shape sets
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_skips(cfg: ModelConfig, shape: str) -> str | None:
    """Why ``cfg`` has no cell at ``shape``, or None, as the reference
    says: an encoder has no decode step, and 500k positions need a
    sub-quadratic (SSM or hybrid) model."""
    if cfg.family == "encoder" and SHAPES[shape]["kind"] == "decode":
        return "encoder-only architecture has no decode step"
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return "long_500k needs sub-quadratic attention; full-attention arch"
    return None


def make_prefill_step(cfg: ModelConfig, max_len: int, *, backend="auto"):
    def prefill(params: M.Model, batch):
        tokens = batch["tokens"]
        caches = M.init_cache(cfg, tokens.shape[0], max_len, device=params.device)
        logits, new_caches, _ = M.forward(params, cfg, tokens, caches=caches,
                                          mrope_pos=batch.get("mrope_pos"), backend=backend)
        return logits[:, -1:], new_caches

    return prefill


def make_serve_step(cfg: ModelConfig, *, backend="auto"):
    def serve_step(params: M.Model, batch):
        return M.decode_step(params, cfg, batch["token"], batch["caches"],
                             mrope_pos=batch.get("mrope_pos"), backend=backend)

    return serve_step


def default_optimizer(cfg: ModelConfig) -> str:
    """Adafactor for the models above 60 B parameters (the reference's
    memory plan), AdamW otherwise."""
    return "adafactor" if cfg.param_count() > 60e9 else "adamw"


def _split(key: str, x: torch.Tensor, accum: int) -> list[torch.Tensor]:
    """A batch entry cut into ``accum`` microbatches along its batch axis
    (axis 1 of ``mrope_pos`` (3, B, S), else axis 0), as the reference's."""
    axis = 1 if key == "mrope_pos" else 0
    b = x.shape[axis]
    if b % accum:
        raise ValueError(f"batch {b} of {key!r} does not split into {accum} microbatches")
    return list(torch.split(x, b // accum, dim=axis))


def make_train_step(cfg: ModelConfig, *, optimizer: str | None = None, lr: float = 3e-4,
                    grad_clip: float = 1.0, dispatch: str | None = None, backend="auto"):
    """``(train_step, init_state, opt_name)``, as the reference's.
    ``train_step(state, batch) -> (state, metrics)`` updates the model and
    the moments in place; metrics (``loss``, ``nll``, ``aux``,
    ``grad_norm``) are float32 scalar tensors on the model's device, read
    without a host sync.  With ``cfg.grad_accum`` > 1 the batch runs as that
    many microbatches, their gradients summed in the parameters' dtype
    (bfloat16 in a bfloat16 model, as the reference's) and divided by
    their number.  ``init_state(gen)`` draws the model from the generator
    (on its device) with gradients on, and zero moments."""
    opt_name = optimizer or default_optimizer(cfg)
    init_opt, update = make_optimizer(opt_name, cosine_schedule(lr, 200, 10_000))

    def loss_and_grads(model: M.Model, batch: dict):
        for t in model.parameters():
            t.grad = None
        loss, metrics = M.lm_loss(model, cfg, batch["tokens"], batch["labels"],
                                  mrope_pos=batch.get("mrope_pos"), dispatch=dispatch,
                                  backend=backend)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: dict):
        model = state.params
        dev = model.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        accum = cfg.grad_accum
        if accum <= 1:
            loss, metrics = loss_and_grads(model, batch)
        else:
            micro = {k: _split(k, v, accum) for k, v in batch.items()}
            acc = {t: torch.zeros_like(t) for t in model.parameters()}
            losses, mets = [], []
            for i in range(accum):
                l, met = loss_and_grads(model, {k: v[i] for k, v in micro.items()})
                losses.append(l)
                mets.append(met)
                for t, a in acc.items():
                    if t.grad is not None:
                        a.add_(t.grad)
            for t, a in acc.items():
                t.grad = a.div_(accum)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        leaves = M.param_leaves(model)

        def grad_of(t):  # a parameter no gradient reached (an idle expert) has a zero one
            return torch.zeros_like(t) if t.grad is None else t.grad

        grads = {k: (tuple(map(grad_of, leaf)) if isinstance(leaf, tuple) else grad_of(leaf))
                 for k, leaf in leaves.items()}
        for t in model.parameters():
            t.grad = None
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        _, opt = update(grads, OptState(state.step, state.opt_m, state.opt_v), leaves)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(model, opt.m, opt.v, opt.step), metrics

    def init_state(gen: torch.Generator) -> TrainState:
        model = M.trainable(M.init(cfg, gen))
        opt = init_opt(M.param_leaves(model))
        return TrainState(model, opt.m, opt.v, 0)

    return train_step, init_state, opt_name

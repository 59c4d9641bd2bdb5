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
kernels, the grouped matmul's backward included).  On a mesh the steps
run unchanged on every rank, each fed its data shard of the batch
(:func:`local_batch`): the serve steps on a ``sorted_ep`` config with
``mesh_axes`` and a mesh registered by
``distributed.moe_parallel.set_current_mesh`` (the experts split over
``"model"``, every other weight whole), the train step of
``make_train_step(..., mesh=)`` on a model whose every leaf and moment is
sharded by the logical-axis rules (:mod:`repro_torch.distributed.fsdp`).

The sharding assembly of a cell is the reference's: :func:`input_specs`
(the inputs as ``meta`` tensors), :func:`abstract_init` and
:func:`abstract_train_state` (the model and the state on
``torch.device("meta")``: shapes, dtypes and logical axes, nothing
allocated), :func:`state_shardings` and :func:`batch_shardings` (the specs
of ``distributed.sharding``: tuples of mesh axes by leaf path, or by batch
entry).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import moe_parallel as MP
from repro_torch.distributed import sharding as SH
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


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """Stand-ins for every model input of the cell (``meta`` tensors of the
    reference's shapes and dtypes, a decode cell's caches as
    ``model.init_cache`` makes them: no allocation but their host
    ``index``)."""
    info = SHAPES[shape]
    b, s, kind = info["batch"], info["seq"], info["kind"]

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    out = {}
    if kind in ("train", "prefill"):
        out["tokens"] = (meta((b, s, cfg.d_model), torch.bfloat16) if cfg.frontend_stub
                         else meta((b, s), torch.int32))
        if kind == "train":
            out["labels"] = meta((b, s), torch.int32)
        if cfg.rope == "mrope":
            out["mrope_pos"] = meta((3, b, s), torch.int32)
    else:
        out["token"] = meta((b, 1), torch.int32)
        out["caches"] = M.init_cache(cfg, b, s, dtype=torch.bfloat16, device="meta")
        if cfg.rope == "mrope":
            out["mrope_pos"] = meta((3, b, 1), torch.int32)
    return out


def abstract_init(cfg: ModelConfig):
    """``(leaves, logical axes)``: each parameter leaf (``model.param_leaves``
    paths, a stack as one ``(L, ...)`` tensor) on ``torch.device("meta")``,
    and the reference's logical spec tree by the same paths."""
    meta = M.abstract_model(cfg)
    leaves = {k: (torch.empty((len(v),) + tuple(v[0].shape), dtype=v[0].dtype, device="meta")
                  if isinstance(v, tuple) else v) for k, v in M.param_leaves(meta).items()}
    return leaves, M.logical_axes(cfg)


def abstract_train_state(cfg: ModelConfig, opt_name: str) -> "TrainState":
    """The train state on ``torch.device("meta")``: leaves, moments (in the
    optimizer's shapes) and step."""
    leaves, _ = abstract_init(cfg)
    init_opt, _ = make_optimizer(opt_name, 1e-3)
    opt = init_opt(leaves)
    return TrainState(leaves, opt.m, opt.v, 0)


def state_shardings(cfg: ModelConfig, mesh, opt_name: str) -> "TrainState":
    """The train state's specs on ``mesh`` (a mesh of ranks or a
    ``sharding.AbstractMesh``): parameters by the logical-axis rules,
    moments by ``sharding.opt_state_specs``, the step replicated."""
    pspecs = SH.tree_specs(M.logical_axes(cfg), SH.rules_for_mesh(mesh))
    step_spec, m_specs, v_specs = SH.opt_state_specs(pspecs, opt_name)
    return TrainState(pspecs, m_specs, v_specs, step_spec)


def batch_shardings(cfg: ModelConfig, mesh, shape: str) -> dict:
    """The cell's input specs: the batch split over the data axes, or
    replicated where it does not divide their ranks (``long_500k``'s batch
    of 1); a decode cell's caches by ``sharding.cache_specs``."""
    info = SHAPES[shape]
    dp_total = math.prod(mesh.shape[a] for a in SH.DATA_AXES if a in mesh.axis_names)
    shard_batch = info["batch"] % dp_total == 0
    out = {}
    for k, v in input_specs(cfg, shape).items():
        if k == "caches":
            cspec = SH.cache_specs(cfg, mesh)
            if not shard_batch:
                cspec = SH.map_specs(lambda s: tuple(None if i == 1 else a
                                                     for i, a in enumerate(s)), cspec)
            out[k] = cspec
        elif k == "mrope_pos":
            out[k] = SH.batch_spec(mesh, v.dim(), batch_axis=1) if shard_batch else ()
        else:
            out[k] = SH.batch_spec(mesh, v.dim()) if shard_batch else ()
    return out


def moment_placements(cfg: ModelConfig, mesh, opt_name: str) -> dict:
    """The checkpoint's placements of a sharded train state's moments: by
    flattened path (``opt_m/<leaf>``, ``opt_v/<leaf>``), each moment's spec
    and global shape (the model's parameters place themselves)."""
    from repro_torch.checkpoint.manager import Placement

    specs, shapes = state_shardings(cfg, mesh, opt_name), abstract_train_state(cfg, opt_name)
    return {f"{field}/{k}": Placement(spec, tuple(getattr(shapes, field)[k].shape))
            for field in ("opt_m", "opt_v") for k, spec in getattr(specs, field).items()}


def local_batch(batch: dict, mesh) -> dict:
    """This rank's data shard of a global batch (rows of axis 1 of
    ``mrope_pos``, of axis 0 elsewhere) over the data axes of ``mesh``,
    which must divide the batch."""
    dp = mesh.sub(tuple(a for a in SH.DATA_AXES if a in mesh.axis_names))
    out = {}
    for k, v in batch.items():
        axis = 1 if k == "mrope_pos" else 0
        n = v.shape[axis]
        if n % dp.world:
            raise ValueError(f"batch {n} of {k!r} does not split over {dp.world} data ranks")
        out[k] = v.narrow(axis, dp.rank * (n // dp.world), n // dp.world)
    return out


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
                    grad_clip: float = 1.0, dispatch: str | None = None, backend="auto",
                    mesh=None, aux_weight: float = 0.01):
    """``(train_step, init_state, opt_name)``, as the reference's.
    ``train_step(state, batch) -> (state, metrics)`` updates the model and
    the moments in place; metrics (``loss``, ``nll``, ``aux``,
    ``grad_norm``) are float32 scalar tensors on the model's device, read
    without a host sync.  With ``cfg.grad_accum`` > 1 the batch runs as that
    many microbatches, their gradients summed in the parameters' dtype
    (bfloat16 in a bfloat16 model, as the reference's) and divided by
    their number.  ``aux_weight`` weighs the MoE load-balance term
    (``lm_loss``'s).  ``init_state(gen)`` draws the model from the generator
    (on its device) with gradients on, and zero moments.

    On a ``mesh`` (every rank makes the same call) the model is drawn
    sharded (``model.init(..., sharded=True)``: each rank its shard of
    every leaf, and so of every moment); ``train_step`` takes the rank's
    data shard of the batch (:func:`local_batch`) and every rank must run
    it; the loss and the gradient norm are the global batch's; a
    ``sorted_ep`` config registers ``mesh`` for its MoE layers."""
    opt_name = optimizer or default_optimizer(cfg)
    layout = None
    if mesh is not None:
        layout = FS.leaf_layout(mesh, M.logical_axes(cfg), M.leaf_shapes(cfg))
        if M._ep_layout(cfg, mesh):
            MP.set_current_mesh(mesh)
    init_opt, update = make_optimizer(opt_name, cosine_schedule(lr, 200, 10_000),
                                      layout=layout)

    def loss_and_grads(model: M.Model, batch: dict):
        for t in model.parameters():
            t.grad = None
        loss, metrics = M.lm_loss(model, cfg, batch["tokens"], batch["labels"],
                                  mrope_pos=batch.get("mrope_pos"), dispatch=dispatch,
                                  aux_weight=aux_weight, backend=backend)
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
        grads, gnorm = clip_by_global_norm(grads, grad_clip, layout)
        _, opt = update(grads, OptState(state.step, state.opt_m, state.opt_v), leaves)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return TrainState(model, opt.m, opt.v, opt.step), metrics

    def init_state(gen: torch.Generator) -> TrainState:
        model = M.trainable(M.init(cfg, gen, mesh=mesh, sharded=mesh is not None))
        opt = init_opt(M.param_leaves(model))
        return TrainState(model, opt.m, opt.v, 0)

    return train_step, init_state, opt_name

"""Model wrapper of the port: embedding → block stacks → head, with init,
forward, the decode caches and the decode step, for every family of the
registry (counterpart of :mod:`repro.models.model`).

Composition per family, as the reference's:

* ``dense`` / ``vlm``: attention + MLP in every layer (``vlm``: M-RoPE and
  a front-end stub);
* ``moe``: ``first_k_dense`` attention + MLP layers (``dense_layers``),
  then attention + MoE (``layers``); MLA where the config has it, and
  deepseek-v3's multi-token-prediction weights (``mtp_block``,
  ``mtp_proj``), which only the training loss reads;
* ``ssm``: Mamba2 blocks;
* ``hybrid`` (zamba2): groups of ``hybrid_shared_period`` Mamba2 blocks,
  each followed by the one shared attention + MLP block on ``concat(x,
  x0)`` through ``shared_in`` plus the group's LoRA;
* ``encoder`` (hubert): non-causal attention + gelu MLP, a front-end stub.

A ``frontend_stub`` model takes precomputed (B, S, D) embeddings in place
of token ids.  :func:`lm_loss` is the training loss (masked cross-entropy,
the MoE load-balance term and deepseek-v3's multi-token prediction);
:func:`trainable` turns a model's gradients on, and with ``cfg.remat``
the blocks and the hybrid's shared block are rematerialized in training.
:func:`param_leaves` presents the parameters as the reference's pytree
leaves (a layer stack as one leaf), which the optimisers and
:func:`train_state_from_numpy` work on.

The model runs where its weights are: :func:`init` draws them on the
generator's device, :func:`params_from_numpy` copies the reference's onto
``device`` (``"cuda"`` unless the caller asks for the CPU).
"""
from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import moe_parallel as MP
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import leaf_shape

# the reference's parameter subtrees stacked over layers (L, ...)
STACKED = ("layers", "dense_layers")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _period(cfg: ModelConfig) -> int:
    """The hybrid's Mamba layers a group, one shared block after each."""
    return cfg.hybrid_shared_period or cfg.n_layers


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // _period(cfg)


class Model(nn.Module):
    """Parameter tree of the reference's ``init`` as modules: ``embed`` (V,
    D); ``layers[i]`` (the reference's stacked ``layers``, row i) and, for a
    dense-prefix MoE stack, ``dense_layers[i]``; the hybrid's ``shared``
    block, ``shared_in`` (2D, D) and its per-group ``lora_a`` (G, 2D, r) and
    ``lora_b`` (G, r, D); ``ln_f``; ``unembed`` (D, V) unless the
    embeddings are tied; ``mtp_block`` and ``mtp_proj`` (2D, D) for MTP."""

    def __init__(self, cfg: ModelConfig, *, device, gen: torch.Generator | None = None,
                 experts=None):
        super().__init__()
        self.cfg = cfg
        dtype = _dtype(cfg)
        kw = dict(dtype=dtype, device=device)
        d = cfg.d_model

        def stack(kind: str, n: int) -> nn.ModuleList:
            return nn.ModuleList(T.Block(cfg, kind, gen=gen, experts=experts, **kw)
                                 for _ in range(n))

        self.layout = None  # a sharded model's Layout (distributed.fsdp)
        self.embed = L.param(L.normal(gen, (cfg.vocab, d), 0.01, **kw), ("vocab", "embed"))
        self.dense_layers = None
        if cfg.family == "ssm":
            self.layers = stack("mamba", cfg.n_layers)
        elif cfg.family == "hybrid":
            n_groups, r = _n_groups(cfg), cfg.hybrid_lora_rank or 16
            self.layers = stack("mamba", cfg.n_layers)
            self.shared = T.Block(cfg, "attn_mlp", gen=gen, **kw)
            self.shared_in = L.Dense(2 * d, d, gen=gen, axes=("mlp", "embed"), **kw)
            self.lora_a = L.param(L.normal(gen, (n_groups, 2 * d, r), 0.01, **kw),
                                  ("layers", "mlp", None))
            self.lora_b = L.param(torch.zeros((n_groups, r, d), **kw), ("layers", None, "embed"))
        elif cfg.moe is not None:
            kd = cfg.moe.first_k_dense
            if kd:
                self.dense_layers = stack("attn_mlp", kd)
            self.layers = stack("attn_moe", cfg.n_layers - kd)
        else:
            self.layers = stack("attn_mlp", cfg.n_layers)
        self.ln_f = L.Norm(d, **kw)
        self.unembed = (None if cfg.tie_embeddings
                        else L.param(L.normal(gen, (d, cfg.vocab), 0.01, **kw),
                                     ("embed", "vocab")))
        if cfg.mtp:  # deepseek multi-token prediction: one extra block and projection
            self.mtp_block = T.Block(cfg, "attn_mlp", gen=gen, **kw)
            self.mtp_proj = L.Dense(2 * d, d, gen=gen, axes=("mlp", "embed"), **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _experts(cfg: ModelConfig, mesh):
    """The expert slice an MoE layer keeps on this rank of ``mesh`` (None:
    every expert)."""
    return None if mesh is None or cfg.moe is None else MP.expert_slice(cfg, mesh)


def abstract_model(cfg: ModelConfig) -> Model:
    """The model on ``torch.device("meta")``: every parameter's shape,
    dtype and logical axes, nothing allocated."""
    return Model(cfg, device=torch.device("meta"))


@functools.lru_cache(maxsize=64)
def _leaves_of(cfg: ModelConfig) -> tuple[dict, dict]:
    meta = abstract_model(cfg)
    axes = {}
    for name, t in meta.named_parameters():
        path = leaf_path(name)
        axes[path] = ("layers",) + t.axes if path.split("/")[0] in STACKED else t.axes
    order = sorted(axes, key=lambda k: k.split("/"))
    return {k: axes[k] for k in order}, {k: leaf_shape(v) for k, v in param_leaves(meta).items()}


def logical_axes(cfg: ModelConfig) -> dict:
    """The reference's logical spec tree (the second value of its
    ``init``), by :func:`param_leaves` path: each leaf's tuple of logical
    axis names, a layer stack's led by ``"layers"``."""
    return dict(_leaves_of(cfg)[0])


def leaf_shapes(cfg: ModelConfig) -> dict:
    """Each :func:`param_leaves` leaf's global shape (a stack's ``(L, ...)``)."""
    return dict(_leaves_of(cfg)[1])


def _ep_layout(cfg: ModelConfig, mesh) -> bool:
    """Whether a sharded model's MoE layers run ``sorted_ep`` on ``mesh``."""
    return (cfg.moe is not None and cfg.moe.dispatch == "sorted_ep"
            and cfg.mesh_axes is not None and MP.EP_AXIS in mesh.axis_names)


def _build(cfg: ModelConfig, dev: torch.device, gen, mesh, sharded: bool) -> Model:
    """The model on ``dev`` (drawn from ``gen``, or uninitialised): with
    ``sharded`` each parameter cut to this rank's shard as it is made
    (:func:`repro_torch.models.layers.cutting`) and the
    :class:`repro_torch.distributed.fsdp.Layout` attached; else, on a mesh,
    only the MoE layers' expert slices."""
    if not sharded:
        return Model(cfg, device=dev, gen=gen, experts=_experts(cfg, mesh))
    if mesh is None:
        raise ValueError("a sharded model needs a mesh")
    SH.check_mesh_device(mesh, dev)
    rules = SH.rules_for_mesh(mesh)
    ep = _ep_layout(cfg, mesh)
    if ep:
        MP.expert_slice(cfg, mesh)  # the experts must split over "model"
    with L.cutting(lambda t, axes: SH.shard_of(t, SH.spec_from_axes(axes, rules), mesh)):
        model = Model(cfg, device=dev, gen=gen)
    names = dict(abstract_model(cfg).named_parameters())
    FS.Layout(mesh, {n: t.axes for n, t in names.items()},
              {n: tuple(t.shape) for n, t in names.items()}, ep=ep).attach(model)
    return model


def init(cfg: ModelConfig, gen: torch.Generator, *, mesh=None, sharded: bool = False) -> Model:
    """Random weights with the reference's scales, drawn one tensor at a
    time in float32 from ``gen`` on its device and cast to the config's
    dtype.  On a ``mesh`` with a ``"model"`` axis each MoE layer keeps only
    this rank's expert slice and router columns
    (:func:`repro_torch.distributed.moe_parallel.expert_slice`): the draw
    is one process's, and a layer's whole expert tensor is held only while
    it is cut.  With ``sharded`` every leaf keeps only this rank's shard by
    the logical-axis rules (:mod:`repro_torch.distributed.fsdp`), each
    tensor cut as it is drawn: every rank draws the one-process model."""
    return _build(cfg, resolve_device(gen.device), gen, mesh, sharded)


def uninitialized(cfg: ModelConfig, *, device="cuda", mesh=None, sharded: bool = False) -> Model:
    """The model with its parameters allocated but not drawn (a restore's
    target); ``mesh`` and ``sharded`` as :func:`init`'s."""
    return _build(cfg, resolve_device(device), None, mesh, sharded)


def trainable(model: Model, on: bool = True) -> Model:
    """Switch every parameter's gradient on (training) or off (serving, as
    the model is built); returns the model."""
    for t in model.parameters():
        t.requires_grad_(on)
    return model


def leaf_path(name: str) -> str:
    """The reference's leaf path (``/``-joined) of a port parameter name:
    ``layers.3.attn.wq.kernel`` is row 3 of ``layers/attn/wq/kernel``."""
    parts = name.split(".")
    if parts[0] in STACKED:
        del parts[1]
    return "/".join(parts)


def param_leaves(model: Model) -> dict:
    """The parameters as the reference's pytree leaves, in its flatten
    order (keys sorted level by level): path -> tensor, or for a layer
    stack (``layers``, ``dense_layers``) the tuple of its layers' tensors,
    one leaf of shape ``(L, ...)`` to the optimisers."""
    groups: dict[str, list] = {}
    for name, t in model.named_parameters():
        groups.setdefault(leaf_path(name), []).append(t)
    return {path: (tuple(groups[path]) if path.split("/")[0] in STACKED else groups[path][0])
            for path in sorted(groups, key=lambda k: k.split("/"))}


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], *, device="cuda",
                      mesh=None, sharded: bool = False) -> Model:
    """The reference's parameter pytree (NumPy arrays; the layer stacks
    stacked ``(L, ...)`` under ``"layers"`` and ``"dense_layers"``) as the
    port's model on ``device``: every leaf copied as it is, no transposes,
    a stack's row i to its layer i, every other subtree (the shared block,
    the LoRA tensors stacked by group, the MTP weights) as it is.  On a
    ``mesh`` with a ``"model"`` axis, each MoE layer takes only this rank's
    slice of ``wi``/``wg``/``wo`` and of the router's columns, as the
    reference's expert-parallel ``shard_map`` hands them to the rank; with
    ``sharded`` every leaf takes only this rank's shard (:func:`init`).
    Raises unless the tree's leaves and the model's parameters match one to
    one."""
    experts = None if sharded else _experts(cfg, mesh)
    model = uninitialized(cfg, device=device, mesh=mesh, sharded=sharded)
    want = dict(model.named_parameters())
    seen = set()

    def put(name: str, value: torch.Tensor) -> None:
        if name not in want:
            raise KeyError(f"reference parameter {name} has no place in the port's model")
        if sharded:
            value = SH.shard_of(value, model.layout.specs[name], mesh)
        if experts is not None and ".moe." in f".{name}":
            lo, hi = experts
            if name.endswith(("moe.wi", "moe.wg", "moe.wo")):
                value = value[lo:hi]
            elif name.endswith("moe.router.kernel"):
                value = value[:, lo:hi]
        dst = want[name]
        if tuple(dst.shape) != tuple(value.shape):
            raise ValueError(f"{name}: reference shape {tuple(value.shape)}, port "
                             f"{tuple(dst.shape)}")
        dst.copy_(value.to(dst.dtype))
        seen.add(name)

    def walk(prefix: tuple, node) -> None:
        if isinstance(node, Mapping):
            for key, sub in node.items():
                walk(prefix + (key,), sub)
            return
        value = _to_torch(node)
        if prefix[0] in STACKED:
            for i in range(value.shape[0]):
                put(".".join((prefix[0], str(i)) + prefix[1:]), value[i])
        else:
            put(".".join(prefix), value)

    with torch.no_grad():
        walk((), tree)
    if seen != set(want):
        raise KeyError(f"port parameters without a reference value: {sorted(set(want) - seen)}")
    return model


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """A nested dict's leaves by ``/``-joined path."""
    out = {}
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        out.update(flatten_tree(sub, path + "/") if isinstance(sub, Mapping) else {path: sub})
    return out


def moment_spec(spec: tuple, leaf_shape: tuple, moment_shape: tuple, first: bool) -> tuple:
    """A moment's spec from its leaf's, as ``sharding.opt_state_specs``
    gives them: the leaf's where the moment has the leaf's shape (AdamW's,
    a 1-D leaf's Adafactor rows), else Adafactor's rows (the ``first``
    moment: the last entry dropped) or columns (the second to last;
    ``(None,)`` for a 1-D leaf)."""
    if tuple(moment_shape) == tuple(leaf_shape):
        return spec
    if first:
        return spec[:-1]
    return spec[:-2] + spec[-1:] if len(leaf_shape) >= 2 else (None,)


def train_state_from_numpy(cfg: ModelConfig, params_tree: Mapping, m_tree: Mapping,
                           v_tree: Mapping, step: int, *, device="cuda", mesh=None):
    """The reference's ``TrainState`` (its parameter pytree and optimiser
    moments as NumPy arrays, and its step) as the port's: the model by
    :func:`params_from_numpy` with gradients on, and each moment leaf as it
    is, by the path of :func:`param_leaves` (AdamW's moments shaped like
    their leaf, Adafactor's row and column moments in the reference's
    shapes: a layer stack's are the stack's).  On a ``mesh`` the model is
    sharded and each moment keeps this rank's shard, by its leaf's spec
    (:func:`moment_spec`)."""
    from repro_torch.launch.steps import TrainState  # the step builders import this module

    model = trainable(params_from_numpy(cfg, params_tree, device=device, mesh=mesh,
                                        sharded=mesh is not None))
    leaves = param_leaves(model)
    dev = model.device
    if mesh is not None:
        specs = SH.tree_specs(logical_axes(cfg), SH.rules_for_mesh(mesh))
        shapes = leaf_shapes(cfg)

    def moments(tree: Mapping, first: bool) -> dict:
        flat = flatten_tree(tree)
        if set(flat) != set(leaves):
            raise KeyError(f"moment leaves {sorted(set(flat) ^ set(leaves))} do not match "
                           "the parameters'")
        out = {}
        for k in leaves:
            t = _to_torch(flat[k])
            if mesh is not None:
                t = SH.shard_of(t, moment_spec(specs[k], shapes[k], t.shape, first), mesh)
            out[k] = t.to(dev)
        return out

    return TrainState(model, moments(m_tree, True), moments(v_tree, False), int(step))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _head(p: Model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(p.ln_f, x, cfg.norm_eps)
    return x @ (p.embed.T if cfg.tie_embeddings else p.unembed)


def _embed_in(p: Model, cfg: ModelConfig, tokens) -> torch.Tensor:
    """(B, S) token ids looked up in ``embed``; a front-end stub's (B, S, D)
    embeddings used as they come, in the model's dtype."""
    tokens = torch.as_tensor(tokens, device=p.device)
    if cfg.frontend_stub and tokens.dim() == 3:
        return tokens.to(_dtype(cfg))
    return p.embed[tokens.to(torch.int64)]


def _index_leaf(caches):
    """The first ``index`` tensor of a cache tree (dicts and tuples), or
    None (Mamba's caches have none)."""
    if isinstance(caches, Mapping):
        return caches.get("index")
    for c in caches or ():
        leaf = None if c is None else _index_leaf(c)
        if leaf is not None:
            return leaf
    return None


def _cache_index(caches) -> int:
    """Tokens already in the caches: the first attention stack's layer-0
    index (a host integer), or 0 where no cache has an index, as the
    reference's."""
    leaf = _index_leaf(caches)
    return 0 if leaf is None else int(leaf.reshape(-1)[0])


def _hybrid_stacks(p: Model, cfg: ModelConfig, x, positions, caches, dispatch, backend, full,
                   mesh=None):
    """Groups of ``period`` Mamba layers, each followed by the shared block
    on ``shared_in(concat(x, x0)) + concat(x, x0) @ lora_a[g] @ lora_b[g]``
    added to x.  ``caches``: None or ``(mamba caches (L, ...), attention
    caches (G, ...))``; returns ``(x, new caches or (None, None), aux)``."""
    period = _period(cfg)
    x0 = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    m_caches, a_caches = (None, None) if caches is None else caches
    new_m, olds_a, new_a = [], [], []
    for g in range(_n_groups(cfg)):
        rows = slice(g * period, (g + 1) * period)
        grp = None if m_caches is None else {k: v[rows] for k, v in m_caches.items()}
        x, nc, a = T.apply_stack(p.layers[rows], cfg, x, positions, caches=grp,
                                 dispatch=dispatch, backend=backend, full=full, mesh=mesh)
        aux = aux + a
        new_m.append(nc)
        a_cache = None if a_caches is None else T.layer_cache(a_caches, g)

        def shared_fn(xx, x00, g=g, cache=a_cache):
            cat = torch.cat([xx, x00], -1)
            h = L.dense(p.shared_in, cat) + (cat @ p.lora_a[g]) @ p.lora_b[g]
            return T.apply_block(p.shared, cfg, h, positions, cache=cache, mesh=mesh)

        if T.remat_on(cfg, x, p.shared, caches):  # the shared blocks' activations dominate
            h, a2 = T.rematerialized(lambda xx, x00, fn=shared_fn: fn(xx, x00)[::2], x, x0)
            na = None
        else:
            h, na, a2 = shared_fn(x, x0)
        x = x + h
        aux = aux + a2
        olds_a.append(a_cache)
        new_a.append(na)
    if caches is None:
        return x, (None, None), aux
    cat_m = {k: torch.cat([c[k] for c in new_m]) for k in m_caches}
    return x, (cat_m, T.restack(a_caches, olds_a, new_a)), aux


def forward(p: Model, cfg: ModelConfig, tokens, *, positions=None, caches=None,
            mrope_pos=None, dispatch=None, backend="auto", mesh=None):
    """tokens (B, S) int, or (B, S, D) embeddings for a front-end stub →
    ``(logits (B, S, V), new_caches, aux_loss)`` on the model's device.
    With ``caches``, positions continue from the caches' index; attention
    rows are written into the caches' tensors in place.  ``mrope_pos`` (3,
    B, S): an ``mrope`` model's (t, h, w) positions.  A dense-prefix MoE
    model's and the hybrid's caches are pairs, their new caches too (``(None,
    None)`` without caches), as the reference's.  A sharded model
    (``init(..., sharded=True)``) runs on its rank's data shard, each
    layer's weights gathered where it runs
    (:mod:`repro_torch.distributed.fsdp`).  On a ``mesh`` the caches are
    the rank's shards (:func:`init_cache` with ``mesh=``), each layer's
    attention or Mamba mixer run on them as ``models.layers`` and
    ``models.ssm`` say."""
    p = FS.full_view(p)
    full = FS.block_view(p)
    x = _embed_in(p, cfg, tokens)
    b, sq = x.shape[:2]
    if positions is None:
        start = 0 if caches is None else _cache_index(caches)
        positions = (start + torch.arange(sq, dtype=torch.int32, device=p.device))[None, :]
        positions = positions.expand(b, sq)
    if mrope_pos is not None:
        mrope_pos = torch.as_tensor(mrope_pos, device=p.device)
    if cfg.family == "hybrid":
        x, new_caches, aux = _hybrid_stacks(p, cfg, x, positions, caches, dispatch, backend,
                                            full, mesh)
    elif p.dense_layers is not None:
        dc, mc = (None, None) if caches is None else caches
        x, ndc, a1 = T.apply_stack(p.dense_layers, cfg, x, positions, caches=dc,
                                   mrope_pos=mrope_pos, full=full, mesh=mesh)
        x, nmc, a2 = T.apply_stack(p.layers, cfg, x, positions, caches=mc,
                                   dispatch=dispatch, backend=backend, full=full, mesh=mesh)
        new_caches, aux = (ndc, nmc), a1 + a2
    else:
        x, new_caches, aux = T.apply_stack(p.layers, cfg, x, positions, caches=caches,
                                           mrope_pos=mrope_pos, dispatch=dispatch,
                                           backend=backend, full=full, mesh=mesh)
    return _head(p, cfg, x), new_caches, aux


# ---------------------------------------------------------------------------
# the training loss
# ---------------------------------------------------------------------------


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor, dp=None) -> torch.Tensor:
    """Mean cross-entropy in float32 over the positions whose label is >= 0.
    The reference contracts a (B, S, V) one-hot to keep vocabulary-sharded
    logits sharded; one device gathers the gold logit instead (the same
    value, without a float32 (B, S, V) one-hot: 1.24 GB at qwen3's vocabulary
    and 2,048 tokens).  On the data ranks ``dp``, each with its shard of
    the batch, it is the global batch's mean, as GSPMD computes it: the
    numerator and the mask count summed over the ranks (the masks differ
    between shards), the value the global loss on every rank and its
    gradient this shard's part."""
    mask = (labels >= 0).to(torch.float32)
    safe = labels.clamp_min(0).to(torch.int64)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    if dp is None or dp.world == 1:
        return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
    count = SH.all_reduce(dp, mask.sum(), "sum")
    local = ((logz - gold) * mask).sum() / count.clamp_min(1.0)
    return local + (SH.all_reduce(dp, local.detach(), "sum") - local.detach())


def lm_loss(p: Model, cfg: ModelConfig, tokens, labels, *, mrope_pos=None, dispatch=None,
            aux_weight: float = 0.01, mtp_weight: float = 0.3, backend="auto"):
    """``(total, {"nll", "aux"})``: the next-token cross-entropy of
    ``labels`` (B, S) (negative labels masked), plus ``aux_weight`` times
    the MoE load-balance loss, plus ``mtp_weight`` times the MTP loss where
    the config has it.  A sharded model's loss is the global batch's
    (:func:`_masked_ce`, ``moe.load_balance``), each rank's tokens and
    labels its data shard of the batch."""
    p = FS.full_view(p)
    dp = getattr(p, "dp_mesh", None)
    labels = torch.as_tensor(labels, device=p.device)
    logits, _, aux = forward(p, cfg, tokens, mrope_pos=mrope_pos, dispatch=dispatch,
                             backend=backend)
    loss = _masked_ce(logits, labels, dp)
    total = loss + aux_weight * aux
    if cfg.mtp:
        total = total + mtp_weight * _mtp_loss(p, cfg, tokens, labels, dp)
    return total, {"nll": loss, "aux": aux}


def _mtp_loss(p: Model, cfg: ModelConfig, tokens, labels, dp=None) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction as the reference approximates it:
    predict t+2 from (emb(t), emb(t+1)) through ``mtp_proj`` and one extra
    ``attn_mlp`` block, then the head; the labels rolled by one, the last
    two masked (no target beyond the sequence's end)."""
    tokens = torch.as_tensor(tokens, device=p.device)
    emb = p.embed[tokens.to(torch.int64)]
    nxt = torch.roll(emb, -1, dims=1)
    h = L.dense(p.mtp_proj, torch.cat([emb, nxt], -1))
    b, sq = tokens.shape
    positions = torch.arange(sq, dtype=torch.int32, device=p.device)[None].expand(b, sq)
    h, _, _ = T.apply_block(p.mtp_block, cfg, h, positions)
    lab2 = torch.roll(labels, -1, dims=1).clone()
    lab2[:, -2:] = -1
    return _masked_ce(_head(p, cfg, h), lab2, dp)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device="cuda", mesh=None):
    """Decode caches stacked over layers, the reference's layout per family,
    in ``dtype`` (bfloat16 by default, whatever the model's dtype) on
    ``device``, each ``index`` (n,) int32 on the host, so that reading it
    costs no device sync:

    * attention: k/v ``(n, B, max_len, KH * kv_dup, Dh)``; MLA the
      compressed ``latent`` ``(n, B, max_len, kv_lora)`` and ``k_rope``
      ``(n, B, max_len, rope)``;
    * Mamba: ``conv`` ``(n, B, K-1, conv_dim)`` and the float32 state
      ``ssm`` ``(n, B, H, P, N)``;
    * ``ssm``: Mamba's over all layers; ``hybrid``: (Mamba's over all
      layers, attention's over the groups); a dense-prefix MoE stack:
      (attention's over the dense layers, attention's over the MoE ones);
      else attention's over all layers.

    On a ``mesh`` (a ``sharding.NamedMesh`` with a ``"model"`` axis, or a
    ``sharding.meta_mesh``) only the rank's shard of each field is
    allocated, its ``"model"`` split by ``sharding.cache_specs`` in GSPMD's
    layout (``ceil(n / ranks)`` a block, the last ones zero-padded);
    ``batch`` is the rank's batch as it is fed (its data shard of the
    global batch, or all of it where the batch is replicated), so a rank's
    bytes equal the spec arithmetic of the global caches."""
    dev = resolve_device(device)
    specs = None
    if mesh is not None:
        specs = SH.map_specs(SH.without_data_axes, SH.cache_specs(cfg, mesh))

    def zeros(shape, dt, spec):
        if spec is not None:
            shape = SH.shard_shape(shape, spec, mesh)
        return torch.zeros(shape, dtype=dt, device=dev)

    def attn_cache(n: int, spec) -> dict:
        if cfg.mla is not None:
            m = cfg.mla
            fields = {"latent": (n, batch, max_len, m.kv_lora_rank),
                      "k_rope": (n, batch, max_len, m.qk_rope_head_dim)}
        else:
            shape = (n, batch, max_len, cfg.n_kv_heads * cfg.kv_dup, cfg.d_head)
            fields = {"k": shape, "v": shape}
        out = {k: zeros(shape, dtype, spec and spec[k]) for k, shape in fields.items()}
        out["index"] = torch.zeros((n,), dtype=torch.int32)
        return out

    def mamba_cache(n: int, spec) -> dict:
        s = cfg.ssm
        conv_dim = cfg.d_inner_ssm + 2 * s.n_groups * s.d_state
        return {"conv": zeros((n, batch, s.d_conv - 1, conv_dim), dtype, spec and spec["conv"]),
                "ssm": zeros((n, batch, cfg.n_ssm_heads, s.head_dim, s.d_state), torch.float32,
                             spec and spec["ssm"])}

    pair = specs if isinstance(specs, tuple) else (specs, specs)
    if cfg.family == "ssm":
        return mamba_cache(cfg.n_layers, specs)
    if cfg.family == "hybrid":
        return mamba_cache(cfg.n_layers, pair[0]), attn_cache(_n_groups(cfg), pair[1])
    if cfg.moe is not None and cfg.moe.first_k_dense:
        kd = cfg.moe.first_k_dense
        return attn_cache(kd, pair[0]), attn_cache(cfg.n_layers - kd, pair[1])
    return attn_cache(cfg.n_layers, specs)


def decode_step(p: Model, cfg: ModelConfig, token, caches, *, mrope_pos=None, backend="auto",
                mesh=None):
    """One-token decode: token (B, 1) → ``(logits (B, 1, V), new caches)``
    (on a ``mesh``, the rank's cache shards: :func:`forward`)."""
    logits, new_caches, _ = forward(p, cfg, token, caches=caches, mrope_pos=mrope_pos,
                                    backend=backend, mesh=mesh)
    return logits, new_caches

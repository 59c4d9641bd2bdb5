"""Model wrapper of the port: embedding → block stack → head, with init,
forward, the decode cache and the decode step (counterpart of
:mod:`repro.models.model`).

Ported families: ``moe`` with ``first_k_dense == 0`` (attention + MoE in
every layer; ``qwen3-moe-30b-a3b``) and ``dense`` (attention + MLP, with
QKV bias, gelu or swiglu, tied embeddings and a duplicated decode cache:
``llama3-8b``, ``qwen2-1.5b``, ``mistral-large-123b``, ``granite-20b``).
MLA, MTP and dense-prefix MoE stacks raise ``NotImplementedError`` naming
ROADMAP Queue 1 item 3b; hybrid, SSM, encoder and VLM families, M-RoPE and
modality front ends item 3c; training, the loss and the optimiser are
item 3d.

The model runs where its weights are: :func:`init` draws them on the
generator's device, :func:`params_from_numpy` copies the reference's onto
``device`` (``"cuda"`` unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not serve yet,
    each piece with the ROADMAP Queue 1 item that ports it: 3b for
    deepseek-v3's blocks (MLA, MTP, dense prefix layers), 3c for the SSM,
    hybrid, encoder and VLM families."""
    missing = []
    if cfg.family not in ("moe", "dense"):
        missing.append((f"family {cfg.family!r}", "3c"))
    if cfg.family == "moe" and (cfg.moe is None or cfg.moe.first_k_dense):
        missing.append(("MoE stacks with dense prefix layers", "3b"))
    if cfg.family == "dense" and cfg.moe is not None:
        missing.append(("a dense family with an MoE config", "3b"))
    for flag, what, item in ((cfg.mla is not None, "MLA", "3b"),
                             (cfg.ssm is not None, "SSM layers", "3c"),
                             (cfg.mtp, "multi-token prediction", "3b"),
                             (cfg.frontend_stub, "modality front ends", "3c"),
                             (cfg.rope == "mrope", "M-RoPE", "3c")):
        if flag:
            missing.append((what, item))
    if missing:
        items = sorted({item for _, item in missing})
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(what for what, _ in missing)} not ported yet "
            f"(ROADMAP Queue 1 item {' and '.join(items)})")


class Model(nn.Module):
    """Parameter tree of the reference's ``init`` as modules:
    ``embed`` (V, D), ``layers[i]`` (the reference's ``layers`` row i),
    ``ln_f``, ``unembed`` (D, V) unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, *, device, gen: torch.Generator | None = None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dtype = _dtype(cfg)
        kw = dict(dtype=dtype, device=device)
        self.embed = L.param(L.normal(gen, (cfg.vocab, cfg.d_model), 0.01, **kw))
        kind = "attn_moe" if cfg.moe is not None else "attn_mlp"
        self.layers = nn.ModuleList(T.Block(cfg, kind, gen=gen, **kw)
                                    for _ in range(cfg.n_layers))
        self.ln_f = L.Norm(cfg.d_model, **kw)
        self.unembed = (None if cfg.tie_embeddings
                        else L.param(L.normal(gen, (cfg.d_model, cfg.vocab), 0.01, **kw)))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init(cfg: ModelConfig, gen: torch.Generator) -> Model:
    """Random weights with the reference's scales, drawn one tensor at a
    time in float32 from ``gen`` on its device and cast to the config's
    dtype."""
    return Model(cfg, device=resolve_device(gen.device), gen=gen)


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any], *, device="cuda") -> Model:
    """The reference's parameter pytree (NumPy arrays; the layer stack
    stacked ``(L, ...)`` under ``"layers"``) as the port's model on
    ``device``: every leaf copied as it is, no transposes.  Raises unless
    the tree's leaves and the model's parameters match one to one."""
    model = Model(cfg, device=resolve_device(device))
    want = dict(model.named_parameters())
    seen = set()

    def put(name: str, value: torch.Tensor) -> None:
        if name not in want:
            raise KeyError(f"reference parameter {name} has no place in the port's model")
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
        if prefix[0] == "layers":
            for i in range(value.shape[0]):
                put(".".join(("layers", str(i)) + prefix[1:]), value[i])
        else:
            put(".".join(prefix), value)

    with torch.no_grad():
        walk((), tree)
    if seen != set(want):
        raise KeyError(f"port parameters without a reference value: {sorted(set(want) - seen)}")
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _head(p: Model, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(p.ln_f, x, cfg.norm_eps)
    return x @ (p.embed.T if cfg.tie_embeddings else p.unembed)


def _cache_index(caches) -> int:
    """Tokens already in the caches (layer 0's index, a host integer)."""
    return int(caches["index"][0])


def forward(p: Model, cfg: ModelConfig, tokens, *, positions=None, caches=None,
            dispatch=None, backend="auto"):
    """tokens (B, S) int → ``(logits (B, S, V), new_caches, aux_loss)`` on
    the model's device.  With ``caches``, positions continue from the
    cache's index and the new K/V rows are written into the caches'
    tensors in place."""
    tokens = torch.as_tensor(tokens, device=p.device).to(torch.int64)
    x = p.embed[tokens]
    b, sq = x.shape[:2]
    if positions is None:
        start = 0 if caches is None else _cache_index(caches)
        positions = (start + torch.arange(sq, dtype=torch.int32, device=p.device))[None, :]
        positions = positions.expand(b, sq)
    x, new_caches, aux = T.apply_stack(p.layers, cfg, x, positions, caches=caches,
                                       dispatch=dispatch, backend=backend)
    return _head(p, cfg, x), new_caches, aux


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """Attention caches stacked over layers: k/v ``(L, B, max_len, KH,
    Dh)`` in ``dtype`` (bfloat16 by default, whatever the model's dtype,
    as the reference) on ``device``, and the filled length ``index`` (L,)
    int32 on the host, so that reading it costs no device sync."""
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads * cfg.kv_dup, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "index": torch.zeros((cfg.n_layers,), dtype=torch.int32)}


def decode_step(p: Model, cfg: ModelConfig, token, caches, *, backend="auto"):
    """One-token decode: token (B, 1) → ``(logits (B, 1, V), new caches)``."""
    logits, new_caches, _ = forward(p, cfg, token, caches=caches, backend=backend)
    return logits, new_caches

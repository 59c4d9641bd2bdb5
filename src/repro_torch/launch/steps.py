"""Serve-step builders of the port (counterpart of the prefill and serve
steps of :mod:`repro.launch.steps`; the training steps are not ported,
ROADMAP Queue 1 item 3d).

``prefill_step``: forward over the whole prompt, building the decode cache.
``serve_step``  : one-token decode against the cache.

Both run eagerly on the model's device and take the reference's batch
dicts: ``tokens`` (B, S) ids or a front-end stub's (B, S, D) embeddings,
``token`` (B, 1) and ``caches`` (any family's, pairs passed through as
they are), and ``mrope_pos`` (3, B, S) for an ``mrope`` model.
``backend`` picks the MoE block's sort and grouped matmul (``"auto"``: by
device; ``"torch"``: the plain versions; ``"cuda"``: the kernels).
"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

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

"""Serve-step builders of the port (counterpart of the prefill and serve
steps of :mod:`repro.launch.steps`; the training steps are not ported,
ROADMAP Queue 1 item 3d).

``prefill_step``: forward over the whole prompt, building the decode cache.
``serve_step``  : one-token decode against the cache.

Both run eagerly on the model's device; ``backend`` picks the MoE block's
sort and grouped matmul (``"auto"``: by device; ``"torch"``: the plain
versions; ``"cuda"``: the kernels).
"""
from __future__ import annotations

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, max_len: int, *, backend="auto"):
    def prefill(params: M.Model, batch):
        tokens = batch["tokens"]
        caches = M.init_cache(cfg, tokens.shape[0], max_len, device=params.device)
        logits, new_caches, _ = M.forward(params, cfg, tokens, caches=caches, backend=backend)
        return logits[:, -1:], new_caches

    return prefill


def make_serve_step(cfg: ModelConfig, *, backend="auto"):
    def serve_step(params: M.Model, batch):
        return M.decode_step(params, cfg, batch["token"], batch["caches"], backend=backend)

    return serve_step

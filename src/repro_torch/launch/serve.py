"""Batched serving driver of the port: prefill the prompts, then greedy
decode against the cache (counterpart of :mod:`repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b \\
        --batch 4 --prompt-len 32 --gen 16 --device cpu

runs the smoke configuration (``--full`` for the published one) on the CPU
with the plain versions; without ``--device`` it runs on the card, through
the MoE blocks' kernels.  Every architecture of the registry serves the
same way: ``deepseek-v3-671b`` (MLA, a dense prefix, MoE through the
kernels), the dense family (``llama3-8b``, ``qwen2-1.5b``, ``granite-20b``,
``mistral-large-123b``), ``mamba2-2.7b``, the hybrid ``zamba2-2.7b``,
``qwen2-vl-2b`` (M-RoPE) and the encoder ``hubert-xlarge``.  As the
reference's ``serve``, a front-end stub's prompt is embedded through a seeded
(V, D) table and its decode steps take token ids; an ``mrope`` model gets
positions ``arange(S)`` on all three axes at prefill and ``S + i`` at
decode step i; the encoder is served like the others (its cached prefill
is causal, as the reference's attention with a cache is).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Generation:
    """``tokens`` (B, gen) greedy ids, the first from the prefill;
    ``logits`` (B, gen, V) float32 on the host when kept; prefill seconds
    and decode seconds per token (host clock, ending in a device sync)."""

    tokens: np.ndarray
    t_prefill: float
    t_decode: float
    logits: np.ndarray | None = None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mrope_positions(batch: int, start: int, length: int, device) -> torch.Tensor:
    """The (3, B, length) M-RoPE ids of text positions ``start`` .. ``start
    + length``: the same position on the t, h and w axes."""
    pos = torch.arange(start, start + length, dtype=torch.int32, device=device)
    return pos.expand(3, batch, length)


def generate(params: M.Model, cfg: ModelConfig, prompts, *, gen: int, max_len: int,
             backend="auto", force=None, keep_logits=False) -> Generation:
    """Prefill ``prompts`` (B, S) token ids, or a front-end stub's (B, S, D)
    embeddings, and decode ``gen - 1`` more tokens greedily.  ``force`` (B,
    gen - 1 or more): feed these tokens instead of the model's own
    (teacher forcing); the greedy ids are still returned.  An ``mrope``
    model gets :func:`mrope_positions` at prefill and at every step."""
    dev = params.device
    prompts = torch.as_tensor(prompts, device=dev)
    b, s = prompts.shape[:2]
    mrope = cfg.rope == "mrope"
    prefill = ST.make_prefill_step(cfg, max_len, backend=backend)
    decode = ST.make_serve_step(cfg, backend=backend)
    batch = {"tokens": prompts}
    if mrope:
        batch["mrope_pos"] = mrope_positions(b, 0, s, dev)
    kept = []
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch)
    out = [logits[:, -1].argmax(-1)]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    if keep_logits:
        kept.append(logits[:, -1].float().cpu())
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok = out[-1] if force is None else torch.as_tensor(force, device=dev)[:, i]
        step = {"token": tok[:, None], "caches": caches}
        if mrope:
            step["mrope_pos"] = mrope_positions(b, s + i, 1, dev)
        logits, caches = decode(params, step)
        out.append(logits[:, -1].argmax(-1))
        if keep_logits:
            kept.append(logits[:, -1].float().cpu())
    _sync(dev)
    t_decode = (time.perf_counter() - t0) / max(1, gen - 1)
    return Generation(
        tokens=torch.stack(out, 1).cpu().numpy(), t_prefill=t_prefill, t_decode=t_decode,
        logits=torch.stack(kept, 1).numpy() if keep_logits else None)


def cache_len(cfg: ModelConfig, positions: int) -> int:
    """Decode-cache positions for ``positions`` tokens: above one KV chunk
    of the chunked attention, rounded up to whole chunks (the positions
    past the filled ones are masked)."""
    ck = cfg.attn_chunk_k
    return positions if positions <= ck else -(-positions // ck) * ck


def serve(arch: str, *, smoke=True, batch=4, prompt_len=32, gen=16, max_len=None, seed=0,
          device="cuda"):
    """Random weights from ``seed`` (a generator on ``device``), seeded
    prompts (a host generator; a front-end stub's embedded through a
    seeded N(0, 0.02^2) table of (V, D)), prefill and greedy decode.
    Returns ``(gen_ids (B, gen), prefill s, decode s per token)``."""
    cfg = get_config(arch, smoke=smoke)
    dev = resolve_device(device)
    max_len = cache_len(cfg, max_len or (prompt_len + gen))
    host = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=host)
    if cfg.frontend_stub:
        prompts = (torch.randn((cfg.vocab, cfg.d_model), generator=host) * 0.02)[prompts]
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    out = generate(params, cfg, prompts, gen=gen, max_len=max_len)
    return out.tokens, out.t_prefill, out.t_decode


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ids, tp, td = serve(args.arch, smoke=not args.full, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                        device=args.device)
    print(f"generated {ids.shape} tokens; prefill {tp*1e3:.1f} ms, "
          f"decode {td*1e3:.2f} ms/token")
    print("sample:", ids[0][:12])


if __name__ == "__main__":
    main()

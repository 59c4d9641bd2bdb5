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
import math
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.types import resolve_device
from repro_torch.distributed import sharding as SH
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
             backend="auto", force=None, keep_logits=False, mesh=None) -> Generation:
    """Prefill ``prompts`` (B, S) token ids, or a front-end stub's (B, S, D)
    embeddings, and decode ``gen - 1`` more tokens greedily.  ``force`` (B,
    gen - 1 or more): feed these tokens instead of the model's own
    (teacher forcing); the greedy ids are still returned.  An ``mrope``
    model gets :func:`mrope_positions` at prefill and at every step.

    On a ``mesh`` every rank makes the call with the global prompts (and
    ``force``) and a model of that mesh (``model.init(..., mesh=,
    sharded=True)`` or ``params_from_numpy(..., mesh=)``): the steps run
    each rank's data shard (the whole batch where it does not divide the
    data ranks), each rank holds its shards of the caches and gets the
    global batch's logits and greedy ids, alike on every rank; the timings
    are the rank's own."""
    dev = params.device
    prompts = torch.as_tensor(prompts, device=dev)
    b, s = prompts.shape[:2]
    mrope = cfg.rope == "mrope"
    prefill = ST.make_prefill_step(cfg, max_len, backend=backend, mesh=mesh)
    decode = ST.make_serve_step(cfg, backend=backend, mesh=mesh)
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
          device="cuda", mesh=None):
    """Random weights from ``seed`` (a generator on ``device``), seeded
    prompts (a host generator; a front-end stub's embedded through a
    seeded N(0, 0.02^2) table of (V, D)), prefill and greedy decode.
    Returns ``(gen_ids (B, gen), prefill s, decode s per token)``.  On a
    ``mesh`` (``sharding.make_mesh`` on every rank, of ``device``'s type)
    every rank makes the call: the config takes the mesh's axes, every
    rank draws the one-process model and keeps its shard of each leaf, and
    :func:`generate` runs on the mesh."""
    cfg = get_config(arch, smoke=smoke)
    dev = resolve_device(device)
    max_len = cache_len(cfg, max_len or (prompt_len + gen))
    host = torch.Generator().manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=host)
    if cfg.frontend_stub:
        prompts = (torch.randn((cfg.vocab, cfg.d_model), generator=host) * 0.02)[prompts]
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh_axes=tuple(mesh.axis_names))
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(seed), mesh=mesh,
                    sharded=mesh is not None)
    out = generate(params, cfg, prompts, gen=gen, max_len=max_len, mesh=mesh)
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
    ap.add_argument("--mesh", default=None,
                    help="data x model shape, e.g. 2x2: serve on that many ranks, started by "
                         "a launcher (torchrun: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); "
                         "NCCL where each rank has a card, else gloo")
    args = ap.parse_args()
    mesh = None
    if args.mesh:
        shape = tuple(int(n) for n in args.mesh.split("x"))
        own_card = args.device == "cuda" and torch.cuda.device_count() >= math.prod(shape)
        SH.init_distributed(backend="nccl" if own_card else "gloo")
        mesh = SH.make_mesh(shape, ("data", "model")[-len(shape):], device=args.device)
    try:
        ids, tp, td = serve(args.arch, smoke=not args.full, batch=args.batch,
                            prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                            device=args.device, mesh=mesh)
    finally:
        if mesh is not None and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        print(f"generated {ids.shape} tokens; prefill {tp*1e3:.1f} ms, "
              f"decode {td*1e3:.2f} ms/token")
        print("sample:", ids[0][:12])


if __name__ == "__main__":
    main()

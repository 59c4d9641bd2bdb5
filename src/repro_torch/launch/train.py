"""Training driver of the port: data loader -> train loop -> checkpoint and
restart (counterpart of :mod:`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
        --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt --device cpu

runs a smoke configuration on the CPU with the plain versions; without
``--device`` it runs on the card, the MoE blocks through the kernels
(``--full`` for the published configuration).  Checkpoints carry the
model, the optimizer's moments and the data loader's cursor, so
``--resume`` continues from the latest one bit for bit as if the run had
not stopped.  On SIGTERM the loop saves a checkpoint and exits (on a
mesh, every rank at the step after which any rank had the signal).

``train(..., mesh=)`` is the same loop on a data x model mesh of ranks
(every rank calls it with the same arguments, as the reference's driver
runs one program on its production mesh): the model and the moments are
sharded by the logical-axis rules, each rank trains on its data shard of
the loader's batch, and the checkpoints hold the gathered leaves in the
one-process format (rank 0 writes them), so ``resume`` works bit for bit
on a mesh and from any mesh's checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import signal
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.types import resolve_device
from repro_torch.data import DataLoader
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models.config import ModelConfig


def frontend_embeddings(cfg: ModelConfig) -> np.ndarray:
    """The reference's stand-in for a modality front end: a fixed (V, D)
    float32 table of N(0, 0.02^2) drawn from seed 0, looked up by token."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(cfg.vocab, cfg.d_model)) * 0.02).astype(np.float32)


def make_batch(cfg: ModelConfig, batch_np: dict, dev: torch.device, emb=None) -> dict:
    """A loader batch on the device: a front-end stub's tokens looked up in
    ``emb``, and for an ``mrope`` model positions ``arange(S)`` on all three
    axes, as the reference's driver builds them."""
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    bsz, seq = batch_np["tokens"].shape
    if cfg.rope == "mrope":
        b["mrope_pos"] = torch.arange(seq, dtype=torch.int32, device=dev).expand(3, bsz, seq)
    if cfg.frontend_stub:
        b["tokens"] = torch.from_numpy(emb[batch_np["tokens"]]).to(dev)
    return b


def train(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8, seq: int = 128,
          ckpt_dir: str | None = None, resume: bool = False, lr: float = 3e-4,
          log_every: int = 10, save_every: int = 25, device="cuda", mesh=None) -> list[float]:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint with
    ``resume``) and return the losses of the steps run here.  The model is
    drawn from seed 0 on ``device``; batches come from ``DataLoader(vocab,
    batch, seq, seed=17)``.  A checkpoint is saved every ``save_every``
    steps, at the last step and on SIGTERM (then the loop stops).  On a
    ``mesh`` (the module docstring) the device is the mesh's and the
    losses are the global batch's; rank 0 alone prints, and the ranks
    agree after each step whether any of them has had a SIGTERM, so that
    all of them save and stop at the same step."""
    cfg = get_config(arch, smoke=smoke)
    if mesh is not None:
        SH.check_mesh_device(mesh, device)
        dev = mesh.device
        cfg = dc.replace(cfg, mesh_axes=tuple(mesh.axis_names))
    else:
        dev = resolve_device(device)
    talk = mesh is None or mesh.rank == 0
    everyone = None if mesh is None else mesh.sub(mesh.axis_names)
    train_step, init_state, opt_name = ST.make_train_step(cfg, lr=lr, mesh=mesh)
    state = init_state(torch.Generator(device=dev).manual_seed(0))
    specs = None if mesh is None else ST.moment_placements(cfg, mesh, opt_name)
    loader = DataLoader(cfg.vocab, batch, seq, seed=17)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and resume and mgr.latest_step() is not None:
        state, manifest = mgr.restore(state, device=dev, mesh=mesh, specs=specs)
        loader = DataLoader.from_state(cfg.vocab, batch, seq, manifest["extras"]["loader"])
        start_step = manifest["step"]
        if talk:
            print(f"resumed from step {start_step}")
    emb = frontend_embeddings(cfg) if cfg.frontend_stub else None

    stop = {"now": False}
    previous = signal.signal(signal.SIGTERM, lambda *_: stop.update(now=True))
    losses = []
    t0 = time.perf_counter()
    try:
        for i in range(start_step, steps):
            b = make_batch(cfg, loader.next(), dev, emb)
            state, metrics = train_step(state, b if mesh is None else ST.local_batch(b, mesh))
            losses.append(float(metrics["loss"]))
            if talk and (i + 1) % log_every == 0:
                dt = (time.perf_counter() - t0) / log_every
                print(f"step {i + 1}: loss={losses[-1]!r} nll={float(metrics['nll']):.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} {dt * 1e3:.0f} ms/step",
                      flush=True)
                t0 = time.perf_counter()
            halt = stop["now"]  # a signal after this line is read at the next step
            if mesh is not None:  # a save is a collective: every rank stops at one step
                halt = bool(SH.host_all_reduce(everyone, [halt], "max")[0])
            if mgr and ((i + 1) % save_every == 0 or halt or i + 1 == steps):
                mgr.save(state, i + 1, extras={"loader": loader.state(), "optimizer": opt_name},
                         blocking=False, mesh=mesh, specs=specs)
            if halt:
                if talk:
                    print("preemption signal: checkpoint saved, exiting")
                break
    finally:
        signal.signal(signal.SIGTERM, previous)
        if mgr:
            mgr.wait()
            if mesh is not None:  # rank 0's files are written before any rank returns
                SH.barrier(everyone)
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="train a registered architecture")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true", help="the published (non-smoke) config")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config (the default; the reference's flag)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    losses = train(args.arch, smoke=not args.full, steps=args.steps, batch=args.batch,
                   seq=args.seq, ckpt_dir=args.ckpt, resume=args.resume, lr=args.lr,
                   log_every=args.log_every, device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f})")


if __name__ == "__main__":
    main()

"""End-to-end LM training on the PyTorch/CUDA port: a ~100M-parameter
llama-family model, a few hundred steps, with a checkpoint and a restart
mid-run (the twin of ``examples/train_lm.py``).

The first half of the steps runs and checkpoints (model, moments, step and
the loader's cursor); then a second call resumes from the checkpoint and
finishes the run as if it had not stopped.  A run of 100 steps or more
must end with a lower loss than the resumed half began with.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
      (the default device is cuda; checkpoints go to a fresh temporary
      directory unless --ckpt names one; TRAIN_LM_LAYERS and TRAIN_LM_VOCAB
      shrink the model for a quick run)
"""
import argparse
import dataclasses as dc
import os
import tempfile

import repro_torch.launch.train as T
from repro_torch.configs import get_config


def main():
    ap = argparse.ArgumentParser(description="train a ~100M-parameter LM with a restart")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ckpt = args.ckpt or tempfile.mkdtemp(prefix="torch_train_lm_")

    # ~100M params: llama-family, 12L x d512 (the 65,536-entry vocabulary's
    # embedding and head hold two thirds of them)
    cfg100m = dc.replace(
        get_config("llama3-8b", smoke=True),
        n_layers=int(os.environ.get("TRAIN_LM_LAYERS", 12)), d_model=512, n_heads=8,
        n_kv_heads=4, d_head=64, d_ff=1408, vocab=int(os.environ.get("TRAIN_LM_VOCAB", 65536)),
        attn_chunk_q=256, attn_chunk_k=256,
    )
    orig = T.get_config

    def patched(name, smoke=False):  # register the config for the driver
        return cfg100m if name == "lm-100m" else orig(name, smoke=smoke)

    T.get_config = patched
    kw = dict(smoke=True, batch=args.batch, seq=args.seq, ckpt_dir=ckpt, lr=1e-3,
              log_every=20, device=args.device)
    n_params = sum(p.numel() for p in T.ST.M.abstract_model(cfg100m).parameters())
    print(f"training a {n_params / 1e6:.1f}M-param LM on {args.device}; first segment ...")
    T.train("lm-100m", steps=args.steps // 2, save_every=50, **kw)
    print("simulated restart: resuming from checkpoint ...")
    losses = T.train("lm-100m", steps=args.steps, resume=True, save_every=100, **kw)
    if args.steps >= 100:
        assert losses[-1] < losses[0], "loss should decrease"
    print("done: loss went from", losses[0], "to", losses[-1])


if __name__ == "__main__":
    main()

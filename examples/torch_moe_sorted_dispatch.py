"""Sort-based MoE dispatch on the PyTorch/CUDA port (the paper's technique
inside the model; the twin of ``examples/moe_sorted_dispatch.py``).

Compares the dense one-hot dispatch with the paper's sorted grouping on a
qwen3-style MoE block with real arrays: the same outputs where no expert
overflows its capacity, and the sorted path's dispatch tensor is E×C×D
(capacity-bounded) against dense's E×T×D.  On the card the sorted path
runs the port's argsort and grouped-matmul kernels.

Run:  PYTHONPATH=src python examples/torch_moe_sorted_dispatch.py [--device cpu]
      (the default device is cuda)
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

ap = argparse.ArgumentParser(description="dense against sorted MoE dispatch")
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)

cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
params = M.init(cfg, torch.Generator(device=dev).manual_seed(0))
moe_p = params.layers[0].moe

B, S = 8, 256
x = torch.randn((B, S, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                device=dev)


def dense(p, x, cfg=cfg):
    return MOE.moe_block(p, cfg, x, dispatch="dense")[0]


def sorted_(p, x, cfg=cfg):
    return MOE.moe_block(p, cfg, x, dispatch="sorted")[0]


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


y_dense = dense(moe_p, x)
y_sorted = sorted_(moe_p, x)
err = float((y_dense - y_sorted).abs().max())
print(f"max |dense − sorted| = {err:.2e}  (capacity factor {cfg.moe.capacity_factor}: "
      f"rows past an expert's capacity are dropped)")
# with room for every row (capacity factor 8) the two dispatches agree
roomy = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
err8 = float((dense(moe_p, x, roomy) - sorted_(moe_p, x, roomy)).abs().max())
print(f"max |dense − sorted| without drops = {err8:.2e}")
assert err8 < 1e-4, err8

for name, fn in [("dense", dense), ("sorted", sorted_)]:
    fn(moe_p, x)
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        fn(moe_p, x)
    sync()
    print(f"{name:7s}: {(time.perf_counter() - t0) / 10 * 1e3:7.2f} ms  "
          f"(E={cfg.moe.num_experts}, T={B * S}, top-{cfg.moe.top_k}, {dev.type})")

e, t = cfg.moe.num_experts, B * S
cap = MOE.capacity(cfg, t)
print(f"dispatch tensor rows: dense E×T = {e * t:,} vs sorted E×C = {e * cap:,} "
      f"({e * t / (e * cap):.0f}× smaller)")
print("sorted dispatch OK")

"""One rank of ``tests/test_torch_train.py``'s sparse all-reduce: joins a
gloo world through a ``file://`` rendezvous, runs ``allreduce_topk`` on its
row of the gradients and puts ``(rank, dense sum, residual)`` on the
queue.  Imports only PyTorch and the port, so spawned ranks start quickly."""
from __future__ import annotations

import traceback

import numpy as np
import torch


def rank_main(rank: int, world: int, rdv: str, grads: np.ndarray, k: int, out) -> None:
    try:
        from repro_torch.distributed import sharding
        from repro_torch.optim import compression as C

        torch.set_num_threads(1)
        sharding.init_distributed(backend="gloo", num_processes=world, process_id=rank,
                                  init_method=f"file://{rdv}")
        mesh = sharding.data_mesh("data", device="cpu")
        g = torch.from_numpy(grads[rank])
        dense, st = C.allreduce_topk(g, C.init_topk(g), k, mesh)
        out.put((rank, dense.numpy(), st.residual.numpy()))
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001  (reported to the test, which fails)
        out.put((rank, None, traceback.format_exc()))

"""Compute/communication overlap: the ring collective matmul (counterpart
of :mod:`repro.distributed.overlap`).

Sequence-parallel layers gather the sequence before their first product:
``y = all_gather(x) @ W``.  The plain form waits for the whole gather
before any product.  The ring form multiplies the chunk of ``x`` this rank
holds into its output row block while the next chunk travels the ring:
``world`` steps, and at step t the chunk that came from rank ``(me - t)
mod world``.  Each step's ``ppermute`` is started before the product and
waited on after it, so the transfer runs beside the product (on gloo the
card's copies to and from host memory run on gloo's own streams).  The
products are ``torch.matmul``, the reference's ``jnp.dot``.  Both
functions take this rank's ``x`` chunk and a replicated ``w`` and return
the whole, replicated ``(S, F)``; they are forward only.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding


def ring_allgather_matmul(mesh, axis: str = "model"):
    """``fn(x (S/P, D) this rank's rows, w (D, F)) -> (S, F)``: the ring.
    ``world - 1`` ``ppermute``s a rank, no all-gather."""
    ring = mesh.sub(axis)
    world = ring.world

    def run(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        s_loc = x.shape[0]
        y = torch.empty((world, s_loc, w.shape[-1]), dtype=x.dtype, device=x.device)
        xs = x
        for t in range(world):
            nxt, work = (sharding.ppermute_start(ring, xs) if t < world - 1 else (None, None))
            y[(ring.rank - t) % world] = torch.matmul(xs, w)
            if work is not None:
                work.wait()
            xs = nxt
        return y.reshape(world * s_loc, w.shape[-1])

    return run


def reference_allgather_matmul(mesh, axis: str = "model"):
    """The unoverlapped baseline: all-gather ``x``, then one product."""
    ring = mesh.sub(axis)

    def run(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.matmul(sharding.all_gather(ring, x).reshape(-1, x.shape[-1]), w)

    return run

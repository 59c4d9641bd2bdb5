"""Sharded aggregation launcher: the launch recipe of the key-range exchange
(counterpart of :mod:`repro.launch.shard_agg`).

One machine (the launcher spawns its ranks itself)::

    PYTHONPATH=src python -m repro_torch.launch.shard_agg --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.shard_agg --world 4 \\
        --dist-backend gloo --device cuda --rows 67108864 --zipf 1.2

``--dist-backend gloo`` runs CPU ranks or several ranks on one card;
``nccl`` needs one card a rank.  Several hosts (one process a rank, the
same command everywhere but the id, ranks not spawned)::

    REPRO_COORDINATOR=host0:1234 REPRO_NUM_PROCESSES=2 REPRO_PROCESS_ID=0 \\
        PYTHONPATH=src python -m repro_torch.launch.shard_agg --dist-backend nccl
    REPRO_COORDINATOR=host0:1234 REPRO_NUM_PROCESSES=2 REPRO_PROCESS_ID=1 \\
        PYTHONPATH=src python -m repro_torch.launch.shard_agg --dist-backend nccl

Each rank draws its own slice of a Zipf-skewed batch (``rows / world``
rows from the seed plus its rank, as each process of the reference draws
its own), runs :func:`repro_torch.core.pipeline.insort_aggregate_device`
on the mesh, and rank 0 prints the exchange's accounting: the per-peer
quota, the fullest segment, the fill fraction, the retries and a rank's
exchange footprint.  ``--check`` also holds the result against a NumPy
oracle of every rank's rows (each rank's bincount, summed over the ranks).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

def _zipf_keys(rng, n, domain, s, dtype):
    """Bounded-domain Zipf(s): p(rank) ∝ 1/rank**s over ``domain`` keys
    (s = 0 is uniform)."""
    import numpy as np

    ranks = np.arange(1, domain + 1, dtype=np.float64)
    p = ranks ** -float(s)
    p /= p.sum()
    return rng.choice(domain, size=n, p=p).astype(dtype)




def run(*, rows=65536, zipf=0.0, policy="rs", memory_rows=4096, batch_rows=512, width=1,
        seed=0, device="cuda", check=False, quiet=False, mesh=None):
    """One rank's part: draw its rows, aggregate on ``mesh`` (default: the
    mesh of every rank :func:`~repro_torch.distributed.sharding.
    init_distributed` joined), return the report (every rank's is the
    same but for ``seconds``)."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import insort_aggregate_device
    from repro_torch.core.types import ExecConfig
    from repro_torch.distributed import groupby as gb
    from repro_torch.distributed import sharding

    mesh = mesh or sharding.data_mesh("shard", device=device)
    world = mesh.world
    if not quiet and mesh.rank == 0:
        print(f"world={world} ranks on {mesh.device} ({mesh.backend} collectives)")
    rows -= rows % world
    # every rank draws its own slice, as each process of the reference does
    rng = np.random.default_rng(seed + mesh.rank)
    domain = max(1024, rows // 4)
    keys = _zipf_keys(rng, rows // world, domain, zipf, np.uint32)
    payload = rng.standard_normal((keys.size, width)).astype(np.float32)
    cfg = ExecConfig(memory_rows=memory_rows, page_rows=256, fanin=8, batch_rows=batch_rows)
    sharding.barrier(mesh)
    t0 = time.perf_counter()
    st, stats = insort_aggregate_device(keys, payload, cfg, policy=policy, mesh=mesh,
                                        mesh_axis="shard", device=mesh.device)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    dt = time.perf_counter() - t0
    local_groups = int(st.occupancy())
    (groups,) = sharding.host_all_reduce(mesh, [local_groups], "sum")
    quota, fill = stats.exchange_quota, stats.exchange_max_fill
    report = {
        "world": world, "processes": world, "rows_global": rows, "zipf_s": zipf,
        "policy": policy, "groups": groups, "rows_exchanged": stats.rows_exchanged,
        "exchange_quota": quota, "exchange_max_fill": fill,
        "fill_frac": round(fill / quota, 4) if quota else 0.0,
        "exchange_retries": stats.exchange_retries,
        "exchange_footprint_rows": gb.exchange_footprint_rows(world, quota) if quota else 0,
        "seconds": round(dt, 4),
    }
    if check:
        report["oracle"] = _check(st, mesh, keys, payload, domain)
    if not quiet and mesh.rank == 0:
        for k, v in report.items():
            print(f"  {k:24s} {v}")
    return report


def _check(st, mesh, keys, payload, domain: int) -> str:
    """Hold the result to a NumPy oracle: every rank bincounts its own rows
    (the keys lie below ``domain``), the counts and float64 sums are summed
    over the ranks, and rank 0 compares them with the gathered shards: keys
    and counts exactly, sums within 1e-3 relative; the shards must come
    sorted by rank.  Every rank raises if rank 0 found a difference."""
    import numpy as np
    import torch

    from repro_torch.core.types import state_to_numpy
    from repro_torch.distributed import groupby as gb
    from repro_torch.distributed import sharding

    whole = state_to_numpy(gb.gather_state(st, mesh))
    cnt = torch.from_numpy(np.bincount(keys, minlength=domain)).to(mesh.device)
    sums = torch.from_numpy(np.bincount(keys, weights=payload[:, 0].astype(np.float64),
                                        minlength=domain)).to(mesh.device)
    cnt, sums = (sharding.all_reduce(mesh, t, "sum").cpu().numpy() for t in (cnt, sums))
    bad = 0
    if mesh.rank == 0:
        live = whole["keys"] != np.iinfo(np.uint32).max
        gk, gc, gs = whole["keys"][live], whole["count"][live], whole["sum"][live][:, 0]
        uk = np.flatnonzero(cnt)
        ok = (gk.size == uk.size and np.array_equal(gk, uk) and np.array_equal(gc, cnt[uk])
              and np.allclose(gs, sums[uk], rtol=1e-3, atol=1e-3))
        bad = 0 if ok else 1
    (bad,) = sharding.host_all_reduce(mesh, [bad], "max")
    if bad:
        raise SystemExit("shard_agg: the result differs from the NumPy oracle")
    return "equal"


def _ended(kw: dict) -> None:
    """``run(**kw)`` on this rank, then the process group torn down, on the
    error path too: gloo's threads must not outlive the interpreter, whose
    exit would abort the rank."""
    import torch.distributed as dist

    try:
        run(**kw)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawned(rank: int, world: int, rdv: str, backend: str, kw: dict) -> None:
    from repro_torch.distributed import sharding

    sharding.init_distributed(backend=backend, num_processes=world, process_id=rank,
                              init_method=f"file://{rdv}")
    _ended(kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--rows", type=int, default=65536, help="global rows (split over ranks)")
    ap.add_argument("--zipf", type=float, default=0.0, help="Zipf skew s (0 = uniform)")
    ap.add_argument("--policy", default="rs",
                    choices=["traditional", "inrun_dedup", "early_agg", "rs"])
    ap.add_argument("--memory-rows", type=int, default=4096)
    ap.add_argument("--batch-rows", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world", type=int, default=1,
                    help="ranks to spawn when no launcher started this process")
    ap.add_argument("--dist-backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--check", action="store_true", help="hold the result to a NumPy oracle")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    kw = dict(rows=args.rows, zipf=args.zipf, policy=args.policy,
              memory_rows=args.memory_rows, batch_rows=args.batch_rows, seed=args.seed,
              device=args.device, check=args.check)
    if args.smoke:
        kw.update(rows=4096, zipf=1.2, memory_rows=1024, batch_rows=256, check=True)
    launched = any(os.environ.get(v) for v in ("REPRO_PROCESS_ID", "RANK"))
    if launched or args.world == 1:
        from repro_torch.distributed import sharding

        sharding.init_distributed(backend=args.dist_backend)
        _ended(kw)
        return 0
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_spawned, args=(args.world, os.path.join(tmp, "rendezvous"),
                                           args.dist_backend, kw),
                           nprocs=args.world, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())

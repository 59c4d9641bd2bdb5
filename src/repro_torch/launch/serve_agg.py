"""Aggregation-serving driver: sustained synthetic ingest with periodic
merge-on-read snapshot queries (counterpart of
:mod:`repro.launch.serve_agg`).

    PYTHONPATH=src python -m repro_torch.launch.serve_agg --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_agg --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_agg \\
        --chunks 200 --chunk-rows 8192 --snapshot-every 25 --policy rs

Drives one :class:`repro_torch.service.AggregationService` session:
synthetic keyed traffic (a drifting hot window, duplicate-heavy within a
chunk) flows through the double-buffered ingest while every
``--snapshot-every`` chunks a snapshot query runs against the live engine.
Reports sustained ingest rows/s and snapshot latency p50/p99, and the
service's metrics.  ``--ttl`` retires keys older than that many snapshot
periods at each snapshot (sessionization).  ``--device`` defaults to
``cuda`` and raises without a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.types import ExecConfig
from repro_torch.service import AggregationService

POLICIES = ("traditional", "inrun_dedup", "early_agg", "rs")


def synth_chunks(n_chunks: int, rows: int, *, keyspace: int, seed: int, drift: float = 0.02):
    """Synthetic keyed traffic: a slowly drifting hot window over a large key
    space — duplicate-heavy inside a chunk (early aggregation has something
    to do), with keys trending upward so that watermark eviction retires
    real data."""
    rng = np.random.default_rng(seed)
    for i in range(n_chunks):
        lo = int(i * drift * keyspace)
        keys = (lo + rng.integers(0, keyspace, rows)).astype(np.uint32)
        pay = rng.standard_normal((rows, 1)).astype(np.float32)
        yield keys, pay


def ttl_cutoff(chunks_done: int, *, ttl: int, snapshot_every: int, keyspace: int,
               drift: float = 0.02) -> int:
    """The key below which rows are older than ``ttl`` snapshot periods
    (0: nothing to retire yet)."""
    return max(0, int((chunks_done - ttl * snapshot_every) * drift * keyspace))


def serve(*, chunks=100, chunk_rows=4096, snapshot_every=20, policy="rs", backend="auto",
          memory_rows=4096, batch_rows=512, ttl=0, overlap=True, warmup=True, seed=0,
          quiet=False, device="cuda"):
    """Run one session; returns the report (rows/s, snapshot latencies, the
    final group count, rows retired, the duplicate rate).

    ``warmup`` first serves a twin session over the same schedule and
    discards it.  The reference does so to fill JAX's compile caches; the
    port compiles nothing per shape (the kernels are built once, at first
    use), so on the card the twin costs a second session's time and no
    compile, and it warms the caching allocator and the kernels' build."""
    cfg = ExecConfig(memory_rows=memory_rows, page_rows=256, fanin=8, batch_rows=batch_rows)
    keyspace = max(1024, chunk_rows)

    def make_service():
        return AggregationService(
            cfg, policy=policy, backend=backend, key_dtype=np.uint32, width=1,
            output_rows=1 << max(12, (chunks * chunk_rows - 1).bit_length()),
            # upper-bound the distinct-key estimate so that the pre-merge
            # planner inserts enough levels for a session's worth of runs
            output_estimate=chunks * chunk_rows,
            overlap=overlap, device=device,
        )

    def cutoff(done):
        return ttl_cutoff(done, ttl=ttl, snapshot_every=snapshot_every, keyspace=keyspace)

    if warmup:
        twin = make_service()
        for i, (k, p) in enumerate(synth_chunks(chunks, chunk_rows, keyspace=keyspace,
                                                seed=seed + 1)):
            twin.ingest(k, p)
            if snapshot_every and (i + 1) % snapshot_every == 0:
                if ttl and cutoff(i + 1) > 0:
                    twin.retire_below(cutoff(i + 1))
                twin.snapshot()
        twin.close()

    svc = make_service()
    t_ingest = 0.0
    rows_done = 0
    t0 = time.perf_counter()
    for i, (keys, pay) in enumerate(synth_chunks(chunks, chunk_rows, keyspace=keyspace,
                                                 seed=seed)):
        svc.ingest(keys, pay)
        rows_done += len(keys)
        if snapshot_every and (i + 1) % snapshot_every == 0:
            t_ingest += time.perf_counter() - t0
            if ttl and cutoff(i + 1) > 0:
                svc.retire_below(cutoff(i + 1))
            state, stats = svc.snapshot()
            if not quiet:
                print(f"  chunk {i + 1:5d}: snapshot groups={int(state.occupancy())} "
                      f"retired={stats.rows_retired} "
                      f"({svc.metrics.snapshot_latencies_s[-1] * 1e3:.1f} ms)")
            t0 = time.perf_counter()
    svc.flush()
    svc.wait()  # the ingest time covers the card's work
    t_ingest += time.perf_counter() - t0
    state, stats = svc.close()
    m = svc.metrics
    return {
        "rows_ingested": m.rows_ingested,
        "ingest_rows_per_s": rows_done / max(t_ingest, 1e-9),
        "snapshots": m.snapshots_taken,
        "snapshot_p50_ms": m.snapshot_latency_s(0.5) * 1e3,
        "snapshot_p99_ms": m.snapshot_latency_s(0.99) * 1e3,
        "final_groups": int(state.occupancy()),
        "rows_retired": int(stats.rows_retired),
        "duplicate_rate": m.duplicate_rate,
        "device": str(svc.device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=100)
    ap.add_argument("--chunk-rows", type=int, default=4096)
    ap.add_argument("--snapshot-every", type=int, default=20)
    ap.add_argument("--policy", default="rs", choices=POLICIES)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--memory-rows", type=int, default=4096)
    ap.add_argument("--batch-rows", type=int, default=512)
    ap.add_argument("--ttl", type=int, default=0,
                    help="retire keys older than TTL snapshot periods (0 = keep everything)")
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    kw = dict(chunks=args.chunks, chunk_rows=args.chunk_rows,
              snapshot_every=args.snapshot_every, policy=args.policy, backend=args.backend,
              memory_rows=args.memory_rows, batch_rows=args.batch_rows, ttl=args.ttl,
              overlap=not args.no_overlap, device=args.device)
    if args.smoke:
        kw.update(chunks=12, chunk_rows=512, snapshot_every=4, memory_rows=256, batch_rows=64)
    r = serve(**kw)
    print(f"ingested {r['rows_ingested']} rows at {r['ingest_rows_per_s'] / 1e6:.2f} M rows/s "
          f"sustained on {r['device']}")
    print(f"{r['snapshots']} snapshots: p50 {r['snapshot_p50_ms']:.1f} ms, "
          f"p99 {r['snapshot_p99_ms']:.1f} ms")
    print(f"final groups {r['final_groups']}, rows retired {r['rows_retired']}, "
          f"duplicate rate {r['duplicate_rate']:.3f}")
    return r


if __name__ == "__main__":
    main()

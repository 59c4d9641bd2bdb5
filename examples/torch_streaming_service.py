"""Aggregation as a service on the PyTorch/CUDA port: sessionization over
an unbounded stream (the twin of ``examples/streaming_service.py``).

One long-lived device-resident session ingests a clickstream minute by
minute; dashboards query it mid-stream with merge-on-read snapshots (the
engine keeps ingesting, nothing is consumed), and a watermark TTL retires
minutes older than the session gap, each retired row accounted in
``stats.rows_retired``.

Run:  PYTHONPATH=src python examples/torch_streaming_service.py [--device cpu]
      (SERVICE_MINUTES / SERVICE_ROWS scale the stream; the default device
      is cuda)
"""
import argparse
import os

import numpy as np

import repro_torch
from repro_torch.core import ExecConfig

ap = argparse.ArgumentParser(description="sessionization over an unbounded stream")
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

rng = np.random.default_rng(0)
MINUTES = int(os.environ.get("SERVICE_MINUTES", 64))
ROWS_PER_MIN = int(os.environ.get("SERVICE_ROWS", 4096))
SNAP_EVERY = max(2, MINUTES // 8)  # dashboard refresh cadence
TTL = 3 * SNAP_EVERY               # session gap: minutes kept live

print(f"== clickstream: {MINUTES} minutes x {ROWS_PER_MIN:,} events, "
      f"snapshot every {SNAP_EVERY} min, TTL {TTL} min, on {dev} ==")

# the watermark column (minute) is the major key column, so a TTL expiry
# is one contiguous packed-key range; the memory budget is well under the
# stream, so the session spills runs and the expiry cuts the run store
sess = repro_torch.serve_aggregate(
    by=repro_torch.KeySpec.of(minute=12, user=14),
    values="ms", aggs=("count", "sum", "avg"), watermark="minute",
    cfg=ExecConfig(memory_rows=4096, page_rows=256, fanin=8, batch_rows=512),
    output_estimate=MINUTES * ROWS_PER_MIN, device=dev,
)

total = 0
for minute in range(MINUTES):
    n = ROWS_PER_MIN
    sess.ingest({
        "minute": np.full(n, minute, np.uint32),
        "user": (rng.zipf(1.4, n) % (1 << 14)).astype(np.uint32),
        "ms": rng.gamma(2.0, 30.0, n).astype(np.float32),
    })
    total += n

    if (minute + 1) % SNAP_EVERY == 0:
        # TTL first: drop minutes that fell out of the session window
        sess.expire_below(minute=max(0, minute + 1 - TTL))
        res = sess.snapshot()  # merge-on-read: ingest continues
        rel = res.relation()
        live_min = int(rel["minute"].min()) if len(rel["count"]) else -1
        print(f"minute {minute + 1:4d}: {len(rel['count']):7,} live "
              f"(minute,user) groups from minute {live_min:3d}, "
              f"{res.stats.rows_retired:7,} rows retired "
              f"[{sess.metrics.snapshot_latencies_s[-1] * 1e3:6.1f} ms]")
        assert live_min >= max(0, minute + 1 - TTL)

m = sess.metrics
print(f"\nmid-stream queries: {m.snapshots_taken} snapshots, "
      f"p50 {m.snapshot_latency_s(0.5) * 1e3:.1f} ms, "
      f"p99 {m.snapshot_latency_s(0.99) * 1e3:.1f} ms")
print(f"duplicate rate {m.duplicate_rate:.3f} (zipf users collapsing into live groups)")

final = sess.close()
rel = final.relation()
# retirement happens at snapshot boundaries, so the surviving events are
# exactly the minutes at or above the last cutoff
last_cut = max(0, (MINUTES // SNAP_EVERY) * SNAP_EVERY - TTL)
survived = int(rel["count"].sum())
print(f"\nfinal drain: {len(rel['count']):,} groups, "
      f"{final.stats.rows_retired:,} store rows retired over the session")
print(f"accounting: surviving events {survived:,} == "
      f"{MINUTES - last_cut} live minutes x {ROWS_PER_MIN:,} "
      f"({total:,} ingested in all) ✓")
assert survived == ROWS_PER_MIN * (MINUTES - last_cut), (survived, last_cut)
assert final.stats.rows_retired > 0
print("sessionized service OK")

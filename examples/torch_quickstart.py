"""Quickstart on the PyTorch/CUDA port: the paper's operator on a
web-log-style workload (the twin of ``examples/quickstart.py``).

Counts distinct users and per-(country, hour) events from 2M unsorted log
records under a 64k-row memory budget (the paper's §2.2 motivating
example): one in-sort operator covers the in-memory, small-output and
large-output regimes, matches hash aggregation's spill and produces
sorted output.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      (QUICKSTART_N=... scales the log size; the default device is cuda)
"""
import argparse
import os

import numpy as np

import repro_torch
from repro_torch.core import (
    ExecConfig,
    finalize,
    group_by,
    hash_aggregate,
    insort_aggregate,
    pack_keys,
    sort_then_stream_aggregate,
)
from repro_torch.data.pipeline import iter_column_batches

ap = argparse.ArgumentParser(description="the paper's operator on a web log")
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

rng = np.random.default_rng(0)
N = int(os.environ.get("QUICKSTART_N", 2_000_000))
n_users = max(16, N // 13)

print(f"== web log: {N:,} records, ~{n_users:,} distinct users, on {dev} ==")
users = (rng.zipf(1.3, N) % n_users).astype(np.uint32)
country = rng.integers(0, 50, N).astype(np.uint32)
hour = rng.integers(0, 24, N).astype(np.uint32)
latency = rng.gamma(2.0, 30.0, N).astype(np.float32)

# memory budget ~N/32 (the paper's external regime), capped at 64k rows
M = max(1 << 10, min(1 << 16, 1 << (N.bit_length() - 5)))
cfg = ExecConfig(memory_rows=M, page_rows=max(64, M // 16), fanin=16,
                 batch_rows=max(256, M // 4))

# 1) SELECT COUNT(DISTINCT user): large input, medium output
state, stats = insort_aggregate(users, None, cfg, output_estimate=n_users, device=dev)
uniq = int(state.occupancy())
print(f"distinct users: {uniq:,}")
print(f"  spill: {stats.total_spill_rows:,} rows "
      f"({stats.runs_generated} runs, {stats.merge_levels} merge levels, "
      f"wide merge index peak {stats.max_index_occupancy:,} rows)")

_, hstats = hash_aggregate(users, None, cfg, output_estimate=uniq, device=dev)
print(f"  hash aggregation spill (baseline): {hstats.total_spill_rows:,} rows")

# 2) SELECT country, hour, count(*), avg(latency) GROUP BY country, hour:
#    small output, early aggregation keeps it in memory (Fig 6)
key = pack_keys(country, hour, 5)
state, stats = group_by(key, latency, cfg, algorithm="insort", output_estimate=50 * 24,
                        device=dev)
out = finalize(state, ("count", "avg"))
print(f"\n(country, hour) groups: {int(state.occupancy())}, "
      f"spill: {stats.total_spill_rows} rows (in-memory, like TPC-H Q1)")
k0 = int(state.keys[0])
print(f"  first group country={k0 >> 5} hour={k0 & 31} "
      f"count={int(out['count'][0])} avg_latency={float(out['avg'][0, 0]):.1f}ms")

# 3) the output is sorted: a GROUP BY + ORDER BY needs no extra sort
ks = state.keys.cpu().numpy()
ks = ks[ks != state.empty]
assert np.all(np.diff(ks) > 0)
print("\noutput arrives sorted: GROUP BY + ORDER BY in one operator ✓")

# 4) the traditional baseline the paper retires
_, tstats = sort_then_stream_aggregate(users[:200_000], None, cfg, device=dev)
_, istats = insort_aggregate(users[:200_000], None, cfg, output_estimate=n_users, device=dev)
print(f"\ntraditional sort-then-aggregate on 200k rows spills "
      f"{tstats.total_spill_rows:,} rows — vs in-sort {istats.total_spill_rows:,}")

# 5) the schema front door: a composite (user, country, hour) key with the
#    full 32-bit user-id space needs 43 bits, so the engine widens to
#    uint64 keys under the hood
spec = repro_torch.KeySpec.of(user=32, country=6, hour=5)
res = repro_torch.aggregate(
    {"user": users, "country": country, "hour": hour}, by=spec, values=latency,
    aggs=repro_torch.AggSpec("count", "avg"), order_by=("user",), cfg=cfg,
    output_estimate=n_users, device=dev,
)
rel = res.relation()
print(f"\nfront door: {res.occupancy():,} (user, country, hour) groups "
      f"[key dtype {res.state.key_dtype}], spill {res.stats.total_spill_rows:,} rows")
print(f"  first group user={rel['user'][0]} country={rel['country'][0]} "
      f"hour={rel['hour'][0]} count={rel['count'][0]} avg={float(rel['avg'][0, 0]):.1f}ms")
print(f"  plan: {res.plan['predicted_spill_insort']:,.0f} predicted in-sort "
      f"spill vs {res.plan['predicted_spill_hash']:,.0f} hash")

# 6) streamed ingest: the same query over an iterator of column batches;
#    the log never needs to be resident at once
log = {"user": users, "country": country, "hour": hour, "latency": latency}
batches = iter_column_batches(log, rows=max(1, N // 8))  # e.g. log shards
res_s = repro_torch.aggregate(
    batches, by=spec, values="latency", aggs=repro_torch.AggSpec("count", "avg"), cfg=cfg,
    output_estimate=n_users, device=dev,
)
rel_s = res_s.relation()
assert np.array_equal(rel_s["user"], rel["user"])
assert np.array_equal(rel_s["count"], rel["count"])
print(f"\nstreamed ingest ({8} batches): {res_s.occupancy():,} groups — "
      f"identical relation, device footprint bounded by the batch size ✓")

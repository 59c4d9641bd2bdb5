"""Interesting orderings end to end on the PyTorch/CUDA port (paper §6.4;
the twin of ``examples/intersect_warehouse.py``).

Part 1: INTERSECT DISTINCT by the sort-based and the hash-based plan,
with exact spill accounting.  Part 2: aggregate each fact table once,
then chain ``merge_join`` and ``rollup`` off the established key order:
no sort after the sources', which the recorded plan shows
(``cost_model.sort_rows == 0``, ``pipeline.re_sorts == 0``).

Run:  PYTHONPATH=src python examples/torch_intersect_warehouse.py [--device cpu]
      (INTERSECT_N scales the input; the default device is cuda)
"""
import argparse
import os

import numpy as np

import repro_torch
from repro_torch.core import ExecConfig, intersect_distinct

ap = argparse.ArgumentParser(description="set operations and an order-preserving pipeline")
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

rng = np.random.default_rng(1)
I = int(os.environ.get("INTERSECT_N", 500_000))
a = rng.integers(0, max(60_000, I // 8), I).astype(np.uint32)
b = rng.integers(30_000, max(90_000, I // 4), I).astype(np.uint32)
est = min(60_000, max(256, I // 8))
cfg = ExecConfig(memory_rows=32_768, page_rows=2_048, fanin=16, batch_rows=8_192)

out_s, st_s = intersect_distinct(a, b, cfg, algorithm="insort", output_estimate=est,
                                 device=dev)
out_h, st_h = intersect_distinct(a, b, cfg, algorithm="hash", output_estimate=est,
                                 device=dev)
ks = out_s.cpu().numpy()  # int64 keys of the u32 domain, EMPTY-padded
ks = ks[ks != np.uint32(0xFFFFFFFF)]
print(f"|A ∩ B| = {len(ks):,}")
print(f"sort-based plan spill: {st_s.total_spill_rows:,} rows "
      f"(each input row spills ≤ once; merge join reads sorted streams)")
print(f"hash-based plan spill: {st_h.total_spill_rows:,} rows "
      f"(DISTINCT twice + join build/probe spill)")
print(f"ratio: {st_h.total_spill_rows / max(1, st_s.total_spill_rows):.2f}×")

# --- Part 2: order-preserving pipeline over the same warehouse -------------
# Two fact tables share a (region, store) dimension; each side pays one
# sort inside its aggregation, and everything after consumes that order.
n = max(4_000, I // 25)
spec = repro_torch.KeySpec.of(region=6, store=10)
sales_cols = {"region": rng.integers(0, 8, n), "store": rng.integers(0, 64, n)}
sales_amount = rng.gamma(2.0, 10.0, n).astype(np.float32)
returns_cols = {"region": rng.integers(0, 8, n), "store": rng.integers(32, 96, n)}
returns_amount = rng.gamma(2.0, 3.0, n).astype(np.float32)

returns = repro_torch.aggregate(returns_cols, by=spec, values=returns_amount,
                                aggs=("count", "sum"), output_estimate=1024, device=dev)
sales = dict(columns=sales_cols, by=spec, values=sales_amount, aggs=("count", "sum"),
             output_estimate=1024, device=dev)
tiers = repro_torch.pipeline([
    ("aggregate", sales),
    ("merge_join", {"right": returns}),  # stores seen on both sides
    ("rollup", {}),                      # grouped by every prefix
])
fine = tiers[("region", "store")]
rel = fine.relation()
print(f"stores with sales AND returns: {len(rel['store']):,} "
      f"(join consumed both sides' sort order)")
print(f"pipeline plan: {fine.plan['pipeline']}")
cm = fine.plan["cost_model"]
print(f"join-side sort term: {cm['sort_rows']:.0f} rows "
      f"(re-sort baseline would sort "
      f"{fine.plan['cost_model_resort_baseline']['sort_rows']:.0f})")
total = tiers[()].relation()
print(f"grand total join pairs: {float(total['join_count'][0]):,.0f}; "
      f"sales in joined stores: {float(np.ravel(total['sum_left'])[0]):,.0f}")

# the anti join answers the complementary question from the same inputs
anti = repro_torch.pipeline([
    ("aggregate", sales),
    ("merge_join", {"right": returns, "how": "anti"}),
])
print(f"stores with sales and NO returns: {anti.occupancy():,} "
      f"(re_sorts={anti.plan['pipeline']['re_sorts']})")
print("order-preserving pipeline OK")

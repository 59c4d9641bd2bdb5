#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and ``nvidia-smi``, and imports nothing
of JAX or of the JAX package ``repro``.  Phases (any failure ends the run
with a non-zero exit):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` for sm_90a;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (u32- and u64-mapped keys, interior EMPTY rows and
   duplicates, unequal merge lengths, both ``assume_unique`` settings) and
   time kernel, plain version and, where one exists, the PyTorch library
   call computing the same function;
3. the main path: ``repro_torch.aggregate`` of TPC-H ``lineitem`` at SF 10
   grouped by ``l_orderkey`` (Q18's inner aggregate: count and sum of
   ``l_quantity``), checked exactly against a NumPy oracle, with every
   kernel's launch count on that run;
4. the u64 path: ``lineitem`` at SF 1 grouped by (``l_partkey``,
   ``l_suppkey``) with SF-10 widths (38 bits), Q20's sum of quantity;
5. SpillStats parity: one spilling input through the card and through the
   port's plain CPU path must give equal relations and ``SpillStats``.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 20201001
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
MAIN_CFG = dict(memory_rows=1 << 20, batch_rows=1 << 16, page_rows=1 << 14, fanin=16)
SPILL_CFG = dict(memory_rows=1 << 14, batch_rows=1 << 12, page_rows=1 << 10, fanin=4)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data: TPC-H lineitem (spec §4.2.3), made with NumPy from a seed
# ---------------------------------------------------------------------------


def lineitem(sf: int, rng, *, part_supp: bool):
    """``l_orderkey`` (sparse: 8 of every 32 keys, 1,500,000·SF orders of
    1–7 lines) and ``l_quantity`` (uniform 1..50), optionally ``l_partkey``
    and ``l_suppkey`` by the partsupp formula.  Rows come in a seeded
    random order; the returned oracle inputs are in order-key order."""
    i = np.arange(int(1_500_000 * sf), dtype=np.int64)
    orderkey = (i // 8) * 32 + (i % 8) + 1
    lines = rng.integers(1, 8, i.size)
    okey = np.repeat(orderkey, lines).astype(np.uint32)
    n = okey.size
    qty = rng.integers(1, 51, n).astype(np.float32)
    cols = {"orderkey": okey, "quantity": qty}
    if part_supp:
        P, S = int(200_000 * sf), int(10_000 * sf)
        partkey = rng.integers(1, P + 1, n)
        j = rng.integers(0, 4, n)
        cols["partkey"] = partkey.astype(np.uint32)
        cols["suppkey"] = ((partkey + j * (S // 4 + (partkey - 1) // S)) % S + 1).astype(np.uint32)
    perm = rng.permutation(n)
    return {k: v[perm] for k, v in cols.items()}, cols


def oracle(keys: np.ndarray, qty: np.ndarray):
    """Group keys, counts and float64 sums by ``np.unique`` + ``reduceat``."""
    if keys.size > 1 and not bool(np.all(keys[1:] >= keys[:-1])):
        order = np.argsort(keys, kind="stable")
        keys, qty = keys[order], qty[order]
    uk, starts, counts = np.unique(keys, return_index=True, return_counts=True)
    return uk, counts, np.add.reduceat(qty.astype(np.float64), starts)


def check_equal(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = "shape" if got.shape != want.shape else int(np.sum(got != want))
        raise SystemExit(f"FAIL {name}: kernel/oracle disagree ({bad} differences)")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / CUDA_CORE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def make_state(rng, n, key_dtype, domain, empty_frac, widths, *, sort=True, dedup=False,
               device):
    """A state with integer-valued payloads (sums exact in any order):
    duplicates from a key ``domain``, interior EMPTY rows before sorting."""
    import torch

    from repro_torch.core import ordered_index as oi
    from repro_torch.core.types import empty_key, rows_to_state, take

    k = rng.integers(0, max(domain, 1), n).astype(np.int64)
    if np.dtype(key_dtype) == np.uint64:  # spread over the mapped u64 domain
        k = k * 2_147_483_659 - (1 << 62)
    k[rng.random(n) < empty_frac] = empty_key(key_dtype)
    pay = rng.integers(0, 50, (n, max(widths))).astype(np.float32)
    st = rows_to_state(torch.from_numpy(k).to(device), torch.from_numpy(pay).to(device),
                       key_dtype=key_dtype, widths=widths)
    if sort:
        st = take(st, oi.argsort_torch(st.keys))
        if dedup:
            st = oi.segmented_combine_torch(st)
    return st


def state_diff(name: str, a, b) -> float:
    """Raise unless keys and counts are equal; the max |difference| of the
    float planes, which must be 0 on integer-valued payloads."""
    import torch

    if not (torch.equal(a.keys, b.keys) and torch.equal(a.count, b.count)):
        raise SystemExit(f"FAIL {name}: keys or counts differ from the plain version")
    err = 0.0
    for f in ("sum", "min", "max"):
        x, y = getattr(a, f), getattr(b, f)
        if x.numel():
            both_inf = torch.isinf(x) & (x == y)
            d = torch.where(both_inf, 0.0, (x - y).abs())
            err = max(err, float(d.max()))
    if err != 0.0:
        raise SystemExit(f"FAIL {name}: planes differ by {err} (tolerance: exact)")
    return err


def row_bytes(state) -> int:
    return 8 + 4 + 4 * sum(state.widths)


def check_kernels(dev, B: int, M: int, P: int) -> list[dict]:
    import torch

    from repro_torch.kernels import bitonic_sort, merge_path, segmented_reduce

    rng = np.random.default_rng(SEED)
    out = []

    # argsort: a batch of B keys, interior EMPTY rows, duplicates
    cases = [(kd, make_state(rng, B, kd, B // 4, 0.2, (0, 0, 0), sort=False, device=dev).keys)
             for kd in (np.uint32, np.uint64)]
    for kd, keys in cases:
        if not torch.equal(bitonic_sort.argsort_cuda(keys), bitonic_sort.argsort_plain(keys)):
            raise SystemExit(f"FAIL argsort {np.dtype(kd)}: permutation differs")
    keys = cases[0][1]
    b_ms, b_by = bound(12 * B, B * math.log2(B))
    out.append(dict(
        name="argsort", route="cuda", source="src/repro_torch/kernels/csrc/argsort.cu",
        replaces="src/repro/kernels/bitonic_sort.py:91", shape=[B], max_abs_err=0.0,
        ms=cuda_ms(lambda: bitonic_sort.argsort_cuda(keys), 50),
        plain_ms=cuda_ms(lambda: bitonic_sort.argsort_plain(keys), 50),
        library_ms=cuda_ms(lambda: torch.argsort(keys, stable=True), 50),
        bound_ms=b_ms, bound_by=b_by,
    ))
    log(f"argsort ok: {out[-1]}")

    # segmented combine: a sorted batch of B rows, several plane layouts
    err = 0.0
    for kd in (np.uint32, np.uint64):
        for widths in ((1, 0, 0), (2, 2, 2), (0, 0, 0)):
            st = make_state(rng, B, kd, B // 8, 0.1, widths, device=dev)
            err = max(err, state_diff(f"segmented_combine {np.dtype(kd)} {widths}",
                                      segmented_reduce.segmented_combine_cuda(st),
                                      segmented_reduce.segmented_combine_plain(st)))
    skew = make_state(rng, B, np.uint32, 1, 0.0, (1, 1, 1), device=dev)  # one group spans all
    err = max(err, state_diff("segmented_combine skew",
                              segmented_reduce.segmented_combine_cuda(skew),
                              segmented_reduce.segmented_combine_plain(skew)))
    st = make_state(rng, B, np.uint32, B // 8, 0.1, (1, 0, 0), device=dev)
    rb = row_bytes(st)
    b_ms, b_by = bound(2 * B * rb, B * (1 + sum(st.widths)))
    out.append(dict(
        name="segmented_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/segmented_combine.cu",
        replaces="src/repro/kernels/segmented_reduce.py:115", shape=[B], max_abs_err=err,
        ms=cuda_ms(lambda: segmented_reduce.segmented_combine_cuda(st), 50),
        plain_ms=cuda_ms(lambda: segmented_reduce.segmented_combine_plain(st), 50),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
    ))
    log(f"segmented_combine ok: {out[-1]}")

    # merge-absorb: replacement selection's (M+2B)+B and the wide merge's
    # (M+P)+P page absorb; tables half to fully occupied
    err = 0.0
    timed = []
    for na, nb, fill in ((M + 2 * B, B, 0.15), (M + P, P, 0.5)):
        for kd in (np.uint32, np.uint64):
            for uniq in (False, True):
                a = make_state(rng, na, kd, 4 * na, fill, (1, 0, 0), dedup=True, device=dev)
                b = make_state(rng, nb, kd, 4 * na, 0.1, (1, 0, 0), dedup=uniq, device=dev)
                err = max(err, state_diff(
                    f"merge_absorb {na}+{nb} {np.dtype(kd)} unique={uniq}",
                    merge_path.merge_absorb_cuda(a, b, assume_unique=uniq),
                    merge_path.merge_absorb_plain(a, b, assume_unique=uniq)))
        rb = row_bytes(a)
        b_ms, b_by = bound(2 * (na + nb) * rb, (na + nb) * (math.log2(na) + 1 + sum(a.widths)))
        timed.append(dict(
            shape=[na, nb],
            ms=cuda_ms(lambda: merge_path.merge_absorb_cuda(a, b), 20),
            plain_ms=cuda_ms(lambda: merge_path.merge_absorb_plain(a, b), 20),
            bound_ms=b_ms, bound_by=b_by,
        ))
    out.append(dict(
        name="merge_absorb", route="cuda", source="src/repro_torch/kernels/csrc/merge_path.cu",
        replaces="src/repro/kernels/merge_path.py:112", max_abs_err=err, library_ms=None,
        **timed[0], other_shapes=timed[1:],
    ))
    log(f"merge_absorb ok: {out[-1]}")
    return out


# ---------------------------------------------------------------------------
# phases 3-5: the port's entry points
# ---------------------------------------------------------------------------


def main_path(dev, rows, ordered) -> dict:
    import torch

    import repro_torch
    from repro_torch.core.types import SYNCS
    from repro_torch.kernels import ops

    cfg = repro_torch.ExecConfig(**MAIN_CFG)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    SYNCS["host_syncs"] = 0
    t0 = time.perf_counter()
    res = repro_torch.aggregate(
        {"orderkey": rows["orderkey"]}, by=repro_torch.KeySpec.of(orderkey=26),
        values=rows["quantity"], aggs=("count", "sum"), cfg=cfg, device=dev,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    host_syncs = SYNCS["host_syncs"]
    peak = torch.cuda.max_memory_allocated()
    rel = res.relation()
    uk, cnt, sums = oracle(ordered["orderkey"], ordered["quantity"])
    check_equal("Q18 keys", rel["orderkey"], uk)
    check_equal("Q18 counts", rel["count"], cnt)
    check_equal("Q18 sums", rel["sum"][:, 0].astype(np.float64), sums)
    n = rows["orderkey"].size
    for k, v in launches.items():
        if v <= 0:
            raise SystemExit(f"FAIL main path: kernel {k} was never launched")
    info = dict(rows=n, groups=int(uk.size), wall_s=wall, rows_per_s=n / wall,
                launches=launches, host_syncs=host_syncs, max_memory_allocated=peak,
                stats=res.stats.as_dict())
    log(f"main path ok: {json.dumps(info)}")
    return info


def u64_path(dev, rng) -> None:
    import torch

    import repro_torch

    rows, _ = lineitem(1, rng, part_supp=True)
    by = repro_torch.KeySpec.of(partkey=21, suppkey=17)
    t0 = time.perf_counter()
    res = repro_torch.aggregate(
        {"partkey": rows["partkey"], "suppkey": rows["suppkey"]}, by=by,
        values=rows["quantity"], aggs=("sum",), cfg=repro_torch.ExecConfig(**MAIN_CFG),
        device=dev,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if res.state.key_dtype != np.uint64:
        raise SystemExit(f"FAIL u64 path: key dtype {res.state.key_dtype}")
    rel = res.relation()
    packed = by.pack({"partkey": rows["partkey"], "suppkey": rows["suppkey"]})
    uk, _, sums = oracle(packed, rows["quantity"])
    check_equal("Q20 keys", by.pack({"partkey": rel["partkey"], "suppkey": rel["suppkey"]}), uk)
    check_equal("Q20 sums", rel["sum"][:, 0].astype(np.float64), sums)
    info = dict(rows=int(packed.size), groups=int(uk.size), wall_s=wall,
                stats=res.stats.as_dict())
    log(f"u64 path ok: {json.dumps(info)}")


def spill_parity(dev, rows) -> None:
    from repro_torch.core import pipeline
    from repro_torch.core.types import ExecConfig, state_to_numpy

    n = 1 << 20
    keys, qty = rows["orderkey"][:n], rows["quantity"][:n]
    cfg = ExecConfig(**SPILL_CFG)
    got = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        state, stats = pipeline.insort_aggregate_device(
            keys, qty, cfg, output_estimate=n, device=d)
        got[d] = (state_to_numpy(state), stats.as_dict(), time.perf_counter() - t0)
    (sa, da, ta), (sb, db, tb) = got[dev], got["cpu"]
    for f in sa:
        check_equal(f"spill parity {f}", sa[f], sb[f])
    if da != db:
        raise SystemExit(f"FAIL spill parity: SpillStats differ\n{da}\n{db}")
    if da["rows_spilled_merge"] == 0 or da["runs_generated"] < 2:
        raise SystemExit(f"FAIL spill parity: the input did not spill through pre-merge: {da}")
    info = dict(rows=n, stats=da, card_s=ta, cpu_s=tb)
    log(f"spill parity ok: {json.dumps(info)}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if "Used" in line:
                log(f"ptxas {name}: {line.strip()}")

    kernels = check_kernels(dev, B=MAIN_CFG["batch_rows"], M=MAIN_CFG["memory_rows"],
                            P=MAIN_CFG["page_rows"])

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    rows, ordered = lineitem(10, rng, part_supp=False)
    log(f"SF10 lineitem: {rows['orderkey'].size} rows made in {time.perf_counter() - t0:.1f} s")
    main = main_path(dev, rows, ordered)
    for k in kernels:
        k["launches"] = main["launches"][k["name"]]
        k["launches_main_path"] = k["launches"]
        k["max_abs_diff"] = k["max_abs_err"]
    u64_path(dev, rng)
    spill_parity(dev, rows)

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

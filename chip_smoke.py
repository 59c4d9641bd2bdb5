#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` and ``nvidia-smi``, and imports nothing
of JAX or of the JAX package ``repro``.  Phases (any failure ends the run
with a non-zero exit):

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` for sm_90a;
2. hold each kernel against its plain PyTorch version on the card on
   seeded edge cases (u32- and u64-mapped keys, interior EMPTY rows and
   duplicates, unequal merge lengths, both ``assume_unique`` settings,
   1- and 4-wide sum planes; the argsort at every edge of its size
   classes, all keys equal and all EMPTY among them; the combine at a
   tile of 2,048 rows - 1, + 0 and + 1 and under one group; the cases a
   look-back across the merge-absorb's tiles gets wrong (the combine runs
   the same pass); the probe's EMPTY tails, hits at the
   right side's ends, keys above it, empty sides; the grouped matmul at
   the four serve shapes, capacities 8 to 264 and widths that are no
   multiple of 64, on the variant its dtype and widths call for);
3. the main path: ``repro_torch.aggregate`` of TPC-H ``lineitem`` at SF 10
   grouped by ``l_orderkey`` (Q18's inner aggregate: count and sum of
   ``l_quantity``), checked exactly against a NumPy oracle, with every
   kernel's launch count on that run; then the same aggregate again
   under ``torch.profiler``: device time by kernel, the merge-absorb
   kernels' sum, and the device's idle share beside the wall;
4. the u64 path: ``lineitem`` at SF 1 grouped by (``l_partkey``,
   ``l_suppkey``) with SF-10 widths (38 bits), Q20's sum of quantity;
5. SpillStats parity: one spilling input (2^20 SF-10 rows at M = 2^14)
   through the card and through the port's plain CPU path, by the main
   path and by every policy and algorithm of phase 10, must give equal
   states and ``SpillStats``;
6. the join path at SF 10 (u32): TPC-H ``orders`` made from the seed,
   ``O = aggregate(orders by o_orderkey, sum o_totalprice)`` merge-joined
   with phase 3's result (Q18's join, 15 M matches), Q4's semi and anti
   joins of the orders of one quarter with the orders that have a line
   committed before it was received, and Q18's join again as one mixed
   sort of both tables (``core.join.join_aggregate``), each against NumPy;
7. the composed pipeline at SF-10 widths (u64): phase 4's aggregate
   merge-joined with SF-1 ``partsupp`` and rolled up to ``partkey`` and
   the grand total with ``repro_torch.pipeline``, against NumPy;
8. the bitonic foil: every merge-absorb input phase 3 gave the merge-path
   kernel, replayed through ``ops.merge_absorb_sorted_bitonic``, must equal
   the merge-path kernel's result exactly; both timed on the shape that
   carried most rows, beside the foil's network size ``m`` and the
   operations one call puts on the card (its plan's global passes, the
   tiles and the fill, one memset);
9. the serve path: ``qwen3-moe-30b-a3b`` at its published widths, random
   weights from the seed, prefill of 4 x 256 tokens and greedy decode to 16
   tokens through the sorted MoE dispatch (the argsort and grouped-matmul
   kernels; every bfloat16 product on the tensor-core variant).  Gates: a
   2-layer float32 copy served with the kernels and
   again with the plain versions on the same weights, teacher-forced,
   must route every token to the same experts, agree on the logits within
   rtol/atol 1e-3 and pick the same greedy tokens; the 48-layer bfloat16
   model is served the same two ways and a third, teacher-forced too,
   with ``torch.bmm`` in place of the grouped-matmul kernel (the witness):
   its logits must be finite, and the kernel's shares of routes and of
   greedy tokens equal to the plain versions' must lie within
   ``WITNESS_SLACK`` of ``torch.bmm``'s or above; every grouped-matmul
   shape lies within one bfloat16 ulp of
   the float32 product plus float32's own bound for summing in another
   order (``gmm_tolerance``);
10. the paper's baselines on phase 3's SF-10 Q18 rows and configuration:
   the device pipeline's ``traditional``, ``inrun_dedup`` and
   ``early_agg`` policies; the host loop (``pipeline="host"``) with
   replacement selection, with read-sort-write early aggregation, and
   with traditional merges in place of the wide merge; the front door's
   ``sort_then_stream``, ``hash``, ``f1_hash`` and ``inmemory``
   algorithms and ``hash`` with ``order_by``; ``intersect_distinct`` of
   the order keys against phase 6's ``orders``.  Each must equal the
   NumPy oracle exactly (a hash result as a set, its rows in hash order)
   and launch its kernels; each logs its wall, rows/s, host syncs, peak
   device memory and ``SpillStats``, and one line puts them side by side
   with phase 3's in-sort run.  The argsort's large class is timed at
   2^20 keys (a traditional batch) and at the SF-10 row count (the
   in-memory sort), beside ``torch.argsort``.

Every path counts its kernels' launches from zero and fails if one of its
kernels was never launched.  While a path runs, the script also copies
the first inputs of every shape it gives each kernel (``capture``); after
it, each kernel must equal its plain version on every one of them, and
the kernels are timed beside their plain versions and library calls on
the inputs of the shape that carried most rows through them (``settle``):
the aggregate kernels on phase 3's, the probe on phase 6's, the bitonic
foil on phase 8's, the grouped matmul on phase 9's, the argsort and the
grouped matmul at every shape a path gave them, with the other paths'
times beside, and the operations one call puts on the card
(``torch.profiler``; the argsort must be one kernel up to 65,536 keys,
the combine two kernels and a memset, and the foil its plan's).  The
last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
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
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
MAIN_CFG = dict(memory_rows=1 << 20, batch_rows=1 << 16, page_rows=1 << 14, fanin=16)
SPILL_CFG = dict(memory_rows=1 << 14, batch_rows=1 << 12, page_rows=1 << 10, fanin=4)
AGG_KERNELS = ("argsort", "segmented_combine", "merge_absorb")
KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "argsort": ("src/repro_torch/kernels/csrc/argsort.cu", "src/repro/kernels/bitonic_sort.py:91"),
    "segmented_combine": ("src/repro_torch/kernels/csrc/segmented_combine.cu",
                          "src/repro/kernels/segmented_reduce.py:115"),
    "merge_absorb": ("src/repro_torch/kernels/csrc/merge_path.cu",
                     "src/repro/kernels/merge_path.py:112"),
    "join_probe": ("src/repro_torch/kernels/csrc/join_probe.cu",
                   "src/repro/kernels/merge_path.py:193"),
    "grouped_matmul": ("src/repro_torch/kernels/csrc/grouped_matmul.cu",
                       "src/repro/kernels/grouped_matmul.py:46"),
    "merge_absorb_bitonic": ("src/repro_torch/kernels/csrc/merge_aggregate.cu",
                             "src/repro/kernels/merge_aggregate.py:75"),
}
# the argsort's kernels by name (csrc/argsort.cu), for the profiler
ARGSORT_KERNELS = ("sort_warp", "sort_block", "sort_cluster", "merge_pass")
RECORD_PATH = {"join_probe": "merge_join", "grouped_matmul": "serve",
               "merge_absorb_bitonic": "bitonic foil"}  # else "aggregate"
SERVE = dict(arch="qwen3-moe-30b-a3b", batch=4, prompt_len=256, gen=16)
# how far below torch.bmm's agreement with the plain versions (routes,
# greedy tokens) the kernel's may fall on the 48-layer bfloat16 serve
WITNESS_SLACK = 0.01

Q4_DAYS = (547, 639)  # [1993-07-01, 1993-10-01) in days after 1992-01-01


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, prefixed with the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


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


_SLEEP_CYCLES_PER_MS: list[float] = []


def _device_sleep(ms: float) -> None:
    """Keep the card busy for about ``ms`` (``torch.cuda._sleep``, its clock
    calibrated once with CUDA events)."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(1 << 22)
        b.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append((1 << 22) / a.elapsed_time(b))
    torch.cuda._sleep(int(ms * _SLEEP_CYCLES_PER_MS[0]))


def cuda_ms(fn, reps: int) -> tuple[float, float]:
    """``(device ms, host ms)`` of one call of ``fn``, each the mean of
    ``reps`` warm calls.  Host: the host clock over calls enqueued back to
    back.  Device: CUDA events around the same calls enqueued while the
    card sleeps for twice the host's time, so that the events time the
    card's work and not the host's (a wrapper's Python can take longer than
    its kernel: timed back to back, the events would measure the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    _device_sleep(2 * host_ms + 1)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_ms / reps


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
    float planes, which must be 0: on every input the script holds a
    kernel to, the payloads are integer-valued with sums below 2^24 or
    one value per key, so any order of addition is exact."""
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


def check_kernels(dev, B: int, M: int, P: int) -> None:
    """Edge cases on seeded inputs: interior EMPTY rows, duplicates, one
    group spanning a batch, u32- and u64-mapped keys, the merge lengths of
    replacement selection and of the wide merge."""
    import torch

    from repro_torch.kernels import bitonic_sort, merge_path, segmented_reduce

    rng = np.random.default_rng(SEED)
    check_argsort(dev, rng, B)
    for kd in (np.uint32, np.uint64):
        for widths in ((1, 0, 0), (2, 2, 2), (0, 0, 0), (4, 0, 0)):
            st = make_state(rng, B, kd, B // 8, 0.1, widths, device=dev)
            state_diff(f"segmented_combine {np.dtype(kd)} {widths}",
                       segmented_reduce.segmented_combine_cuda(st),
                       segmented_reduce.segmented_combine_plain(st))
    # one group spans all tiles; a tile of the fused pass - 1, a tile, a tile + 1
    for n, domain in ((B, 1), (2047, 300), (2048, 300), (2049, 300), (2049, 1)):
        st = make_state(rng, n, np.uint32, domain, 0.1 if domain > 1 else 0.0, (1, 1, 1),
                        device=dev)
        state_diff(f"segmented_combine {n} rows, domain {domain}",
                   segmented_reduce.segmented_combine_cuda(st),
                   segmented_reduce.segmented_combine_plain(st))
    for na, nb, fill in ((M + 2 * B, B, 0.15), (M + P, P, 0.5)):
        for kd in (np.uint32, np.uint64):
            for uniq in (False, True):
                for widths in ((1, 0, 0), (4, 0, 0)):
                    a = make_state(rng, na, kd, 4 * na, fill, widths, dedup=True, device=dev)
                    b = make_state(rng, nb, kd, 4 * na, 0.1, widths, dedup=uniq, device=dev)
                    state_diff(f"merge_absorb {na}+{nb} {np.dtype(kd)} {widths} unique={uniq}",
                               merge_path.merge_absorb_cuda(a, b, assume_unique=uniq),
                               merge_path.merge_absorb_plain(a, b, assume_unique=uniq))
    check_merge_lookback(dev, rng, P=P)
    check_probe(dev, rng)
    check_bitonic(dev, rng)
    check_grouped_matmul(dev)
    log("kernels ok on the edge cases")


def check_argsort(dev, rng, B: int) -> None:
    """The argsort kernel equals its plain version at every edge of its size
    classes (``bitonic_sort.plan``: the warp's 32, the block's 1,024, the
    clusters' CTAs up to the batch B = 65,536, the large class above), u32-
    and u64-mapped keys: duplicates, 30% interior EMPTY rows, all keys equal
    (the order across CTAs and clusters is the rows') and all EMPTY."""
    import torch

    from repro_torch.kernels import bitonic_sort

    for n in (1, 32, 33, 1024, 1025, 2048, 2049, 8191, 8192, 8193, B - 1, B, B + 1, 1 << 20):
        for kd in (np.uint32, np.uint64):
            for what, domain, empty in (("duplicates", max(1, n // 4), 0.0),
                                        ("30% empty", max(1, n // 4), 0.3),
                                        ("all equal", 1, 0.0), ("all empty", 1, 1.0)):
                keys = make_state(rng, n, kd, domain, empty, (0, 0, 0), sort=False,
                                  device=dev).keys
                if not torch.equal(bitonic_sort.argsort_cuda(keys),
                                   bitonic_sort.argsort_plain(keys)):
                    raise SystemExit(f"FAIL argsort n={n} {np.dtype(kd)} {what} "
                                     f"{bitonic_sort.plan(n)}: permutation differs")


def check_merge_lookback(dev, rng, P: int) -> None:
    """The merge-absorb kernel equals its plain version in the cases a
    look-back across its tiles of 2,048 output rows gets wrong: one key
    for every row (a group spanning every tile, at the wide merge's
    shape too), an all-EMPTY side, empty sides, totals of a tile - 1, a
    tile and a tile + 1 (one and two tiles), very unequal sides, and
    min/max planes whose neutral values are +-inf; u32- and u64-mapped
    keys, duplicates on both sides.  The group of a million rows carries
    min and max planes only: its sum would pass 2^24, where float32 sums
    in another order are no longer exact."""
    from repro_torch.kernels import merge_path

    big = (1 << 20) + P  # the wide merge's pages: (M + P) + P rows
    cases = [(70_000, 5_000, 1, 0.0, 0.0, (1, 1, 1)), (big, P, 1, 0.0, 0.0, (0, 1, 1)),
             (6_000, 2_500, 50, 1.0, 0.1, (1, 1, 1)), (2_500, 6_000, 50, 0.1, 1.0, (1, 1, 1)),
             (0, 5_000, 900, 0.0, 0.2, (2, 2, 2)), (5_000, 0, 900, 0.2, 0.0, (2, 2, 2)),
             (0, 0, 1, 0.0, 0.0, (1, 0, 0))]
    cases += [(n - n // 3, n // 3, 300, 0.1, 0.1, (1, 0, 0)) for n in (2047, 2048, 2049)]
    cases += [(n - 1000, 1000, 600, 0.1, 0.1, (0, 2, 2)) for n in (4095, 4096, 4097)]
    cases += [(5, 70_000, 20_000, 0.0, 0.1, (4, 0, 0)),
              (1, big + P - 1, 1 << 20, 0.0, 0.3, (1, 0, 0)),
              (big + P - 1, 1, 1 << 20, 0.3, 0.0, (1, 0, 0)),
              (200_000, 3, 50_000, 0.1, 0.0, (4, 0, 0)),
              (40_000, 40_000, 2_000, 0.05, 0.05, (2, 2, 2))]
    for kd in (np.uint32, np.uint64):
        for na, nb, domain, empty_a, empty_b, widths in cases:
            a = make_state(rng, na, kd, domain, empty_a, widths, device=dev)
            b = make_state(rng, nb, kd, domain, empty_b, widths, device=dev)
            state_diff(f"merge_absorb look-back {na}+{nb} domain {domain} {np.dtype(kd)} "
                       f"{widths}", merge_path.merge_absorb_cuda(a, b),
                       merge_path.merge_absorb_plain(a, b))


def check_bitonic(dev, rng) -> None:
    """The bitonic merge-absorb equals its plain version and the merge-path
    kernel's plain version exactly: test_kernels.py's tiles (n = 64, 256,
    1024 a side, keys from n/2), EMPTY tails, unequal sides, one key for
    all rows, 1- and 4-wide planes, and the edges of its plan
    (``merge_aggregate.plan``, a tile of 8,192 words): m one tile, a tile x
    2 and x 8 each -1 and +1 row, |a| + |b| above the larger side's next
    power of two n (m = 2n), B empty, and m = 2^22 (two global passes of
    five and four stages)."""
    from repro_torch.kernels import merge_aggregate, merge_path

    cases = [(n, n, n // 2, 0.0, (2, 2, 2)) for n in (64, 256, 1024)]
    cases += [(3000, 500, 5000, 0.2, (1, 0, 0)), (5, 70_000, 50_000, 0.1, (4, 0, 0)),
              (1 << 16, 4096, 1, 0.0, (1, 1, 1)), (0, 9, 20, 0.0, (1, 0, 0)),
              (1_064_960, 16_384, 1 << 24, 0.3, (1, 0, 0))]
    cases += [(6000, 2192, 3000, 0.1, (1, 0, 0)), (10_000, 6383, 5000, 0.1, (1, 1, 1)),
              (10_000, 6385, 5000, 0.1, (1, 0, 0)), (60_000, 5535, 40_000, 0.1, (1, 0, 0)),
              (60_000, 5537, 1, 0.0, (2, 0, 0)), (5000, 4000, 2000, 0.2, (1, 1, 1)),
              (70_000, 0, 30_000, 0.1, (1, 0, 0)),
              (1_179_648, 1_179_648, 1 << 22, 0.3, (1, 0, 0))]
    for na, nb, domain, fill, widths in cases:
        a = make_state(rng, na, np.uint32, domain, fill, widths, dedup=True, device=dev)
        b = make_state(rng, nb, np.uint32, domain, fill, widths, device=dev)
        got = merge_aggregate.merge_absorb_bitonic_cuda(a, b)
        state_diff(f"merge_absorb_bitonic {na}+{nb} {widths}", got,
                   merge_aggregate.merge_absorb_bitonic_plain(a, b))
        state_diff(f"merge_absorb_bitonic {na}+{nb} {widths} vs merge path", got,
                   merge_path.merge_absorb_plain(a, b))


def gmm_tolerance(x, w, capacity: int):
    """The float32 product of a grouped matmul and the tolerance of each
    output element: one ulp of the output dtype at the product, plus twice
    float32's bound for a sum of D products in another order (D * 2^-24 *
    sum |x| |w|, for the kernel's sum and for the product's): near zero a
    sum of products that cancel carries more float32 error than one
    bfloat16 ulp of the result."""
    import torch

    e, d, f = w.shape
    xs = x.reshape(e, capacity, d).float()
    want32 = torch.einsum("ecd,edf->ecf", xs, w.float()).reshape(e * capacity, f)
    mag = torch.einsum("ecd,edf->ecf", xs.abs(), w.float().abs()).reshape(e * capacity, f)
    _, ex = torch.frexp(want32)
    bits = 8 if x.dtype == torch.bfloat16 else 24
    tol = torch.ldexp(torch.ones_like(want32), ex - bits) + 2 * d * 2.0 ** -24 * mag
    return want32, tol


def gmm_error(x, w, capacity: int, got=None) -> tuple[float, float]:
    """The grouped-matmul kernel (or its output ``got``) against the float32
    product: (max |kernel - plain version|, max |kernel - product| in units
    of :func:`gmm_tolerance`)."""
    from repro_torch.kernels import grouped_matmul

    if got is None:
        got = grouped_matmul.grouped_matmul_cuda(x, w, capacity=capacity)
    if got.numel() == 0:
        return 0.0, 0.0
    want32, tol = gmm_tolerance(x, w, capacity)
    ratio = float(((got.float() - want32).abs() / tol).max())
    return float((got.float() - want32.to(x.dtype).float()).abs().max()), ratio


def check_grouped_matmul(dev) -> None:
    """The four serve shapes at the served model's widths (wg/wi 2048 ->
    768 and wo 768 -> 2048 at decode's C = 8 and prefill's C = 64),
    capacities 13, 72 and 264 (two N tiles of the tensor cores), D and F
    that are multiples of 8 but not of 64, widths that are no multiple of
    8 (the CUDA-core variant in bfloat16 too), one expert; bfloat16 and
    float32; padding rows zero; each on the variant its dtype and widths
    call for and within :func:`gmm_tolerance` of the float32 product."""
    import torch

    from repro_torch.kernels import grouped_matmul

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for dtype in (torch.bfloat16, torch.float32):
        # bf16: the variant bfloat16 takes at these widths (float32: the CUDA cores)
        for e, c, d, f, bf16 in ((128, 8, 2048, 768, "wgmma"), (128, 8, 768, 2048, "wgmma"),
                                 (128, 64, 2048, 768, "wgmma"), (128, 64, 768, 2048, "wgmma"),
                                 (3, 13, 200, 136, "wgmma"), (5, 72, 136, 200, "wgmma"),
                                 (2, 264, 200, 136, "wgmma"), (16, 72, 200, 130, "simt"),
                                 (1, 64, 96, 257, "simt"), (3, 13, 1000, 1000, "wgmma")):
            x = torch.randn((e * c, d), generator=gen, device=dev).to(dtype)
            x.view(e, c, d)[:, c // 2:] = 0  # capacity padding
            w = (torch.randn((e, d, f), generator=gen, device=dev) / math.sqrt(d)).to(dtype)
            want = bf16 if dtype == torch.bfloat16 else "simt"
            got, launched = grouped_matmul.grouped_matmul_launch(x, w, capacity=c)
            if launched != want:
                raise SystemExit(f"FAIL grouped_matmul {dtype} D={d} F={f}: the {launched} "
                                 f"variant, expected {want}")
            err, ratio = gmm_error(x, w, c, got=got)
            if ratio > 1.0:
                raise SystemExit(f"FAIL grouped_matmul {dtype} E={e} C={c} D={d} F={f} "
                                 f"({want}): {ratio:.3f} x the tolerance (max |diff| {err})")
            if e == 128:  # the library's product against the same tolerance
                ref = torch.bmm(x.view(e, c, d), w).view(e * c, f)
                _, lib = gmm_error(x, w, c, got=ref)
                plain = grouped_matmul.grouped_matmul_plain(x, w, capacity=c)
                log(f"grouped_matmul {dtype} C={c} {d}->{f} ({want}): kernel {ratio:.3f}, "
                    f"torch.bmm {lib:.3f} x the tolerance; max |kernel - plain| {err}; "
                    f"outputs equal to the plain version's: kernel "
                    f"{float((got == plain).float().mean()):.4f}, torch.bmm "
                    f"{float((ref == plain).float().mean()):.4f}")


def probe_keys(rng, n, m, key_dtype, device):
    """Sorted, duplicate-free key vectors with EMPTY tails: ``b`` holds
    ``m`` valid keys; ``a`` about ``n``, among them b's first and last key
    and one key above all of b's."""
    from repro_torch.core.types import keys_to_torch

    domain = 4 * max(n, m, 1)
    b = np.unique(rng.integers(1, domain, m))[:m]
    a = np.unique(rng.integers(0, domain, n))
    if n:
        extra = [domain + 7] + ([b[0], b[-1]] if b.size else [])
        a = np.unique(np.concatenate([a[: max(n - 3, 0)], extra]))
    out = []
    for k in (a, b):
        k = k.astype(np.uint64)
        if np.dtype(key_dtype) == np.uint64:  # spread over both halves of the u64 domain
            k = k * np.uint64(0x9E3779B97F4A7C15 // (domain + 8))
        tail = np.full(k.size // 8 + (k.size > 0), np.iinfo(key_dtype).max, np.uint64)
        out.append(keys_to_torch(np.concatenate([k, tail]).astype(key_dtype), device))
    return out


def check_probe(dev, rng) -> None:
    """The probe kernel must equal its plain version exactly, on ``pos`` and
    ``hit``, in every edge case."""
    import torch

    from repro_torch.core.types import empty_key
    from repro_torch.kernels import merge_path

    for kd in (np.uint32, np.uint64):
        empty = empty_key(kd)
        for n, m in ((0, 100), (100, 0), (0, 0), (1, 1), (2, 1), (5000, 1200), (1200, 5000),
                     (1 << 20, 3 << 20)):
            a, b = probe_keys(rng, n, m, kd, dev)
            pos, hit = merge_path.join_probe_cuda(a, b, empty)
            want_pos, want_hit = merge_path.join_probe_plain(a, b, empty)
            if not (torch.equal(pos, want_pos) and torch.equal(hit, want_hit)):
                raise SystemExit(f"FAIL join_probe {np.dtype(kd)} n={n} m={m}: differs from "
                                 "the plain version")
            if n and int(hit.sum()) < min(2, m):
                raise SystemExit(f"FAIL join_probe {np.dtype(kd)} n={n} m={m}: the first and "
                                 "last right keys did not hit")


# ---------------------------------------------------------------------------
# every path: each kernel against its plain version on the inputs the path
# gave it, and the kernels' times there
# ---------------------------------------------------------------------------


def _kernel_table():
    """name -> (module, launch function (the one ``ops`` calls), plain
    function, signature of a call, copy of a call's inputs)."""
    import torch

    from repro_torch.kernels import (
        bitonic_sort,
        grouped_matmul,
        merge_aggregate,
        merge_path,
        segmented_reduce,
    )

    def copy(s):
        return s.map(torch.clone)

    return {
        "argsort": (bitonic_sort, "argsort_cuda", "argsort_plain",
                    lambda k: (k.shape[0],), lambda k: ((k.clone(),), {})),
        "segmented_combine": (segmented_reduce, "segmented_combine_cuda",
                              "segmented_combine_plain",
                              lambda s: (s.capacity, s.widths), lambda s: ((copy(s),), {})),
        "merge_absorb": (merge_path, "merge_absorb_cuda", "merge_absorb_plain",
                         lambda a, b, assume_unique=False: (a.capacity, b.capacity, a.widths,
                                                            assume_unique),
                         lambda a, b, assume_unique=False: ((copy(a), copy(b)),
                                                            {"assume_unique": assume_unique})),
        "join_probe": (merge_path, "join_probe_cuda", "join_probe_plain",
                       lambda a, b, empty: (a.shape[0], b.shape[0]),
                       lambda a, b, empty: ((a.clone(), b.clone(), empty), {})),
        "grouped_matmul": (grouped_matmul, "grouped_matmul_launch", "grouped_matmul_plain",
                           lambda x, w, capacity: (x.shape[0], x.shape[1], w.shape[2], capacity,
                                                   str(x.dtype).replace("torch.", "")),
                           lambda x, w, capacity: ((x.clone(), w.clone()),
                                                   {"capacity": capacity})),
        "merge_absorb_bitonic": (merge_aggregate, "merge_absorb_bitonic_cuda",
                                 "merge_absorb_bitonic_plain",
                                 lambda a, b: (a.capacity, b.capacity, a.widths),
                                 lambda a, b: ((copy(a), copy(b)), {})),
    }


CAPTURED: dict[str, dict] = {}  # path -> kernel -> {signature: [calls, (args, kwargs)]}


@contextlib.contextmanager
def capture(path: str):
    """While a path runs, note every call of each kernel's launch function:
    how many calls came with each signature (shapes, plane widths), and a
    copy of the first call's inputs of each.  Counts nothing: the launch
    counts stay with ``ops``."""
    seen = CAPTURED.setdefault(path, {})
    table = _kernel_table()
    saved = []
    for name, (mod, launch, _, sig, snap) in table.items():
        orig = getattr(mod, launch)

        def tap(*args, _orig=orig, _sig=sig, _snap=snap, _seen=seen.setdefault(name, {}),
                **kw):
            key = _sig(*args, **kw)
            if key not in _seen:
                _seen[key] = [0, _snap(*args, **kw)]
            _seen[key][0] += 1
            return _orig(*args, **kw)

        saved.append((mod, launch, orig))
        setattr(mod, launch, tap)
    try:
        yield
    finally:
        for mod, launch, orig in saved:
            setattr(mod, launch, orig)


def _compare(name: str, args, kw) -> float:
    import torch

    mod, launch, plain, _, _ = _kernel_table()[name]
    got = getattr(mod, launch)(*args, **kw)
    if name == "grouped_matmul":  # (output, variant)
        err, ratio = gmm_error(*args, kw["capacity"], got=got[0])
        if ratio > 1.0:
            raise SystemExit(f"FAIL grouped_matmul: {ratio:.3f} x the tolerance")
        return err
    want = getattr(mod, plain)(*args, **kw)
    if name in ("argsort", "join_probe"):
        same = (torch.equal(got, want) if name == "argsort"
                else all(torch.equal(x, y) for x, y in zip(got, want)))
        if not same:
            raise SystemExit(f"FAIL {name}: differs from the plain version")
        return 0.0
    return state_diff(name, got, want)


MAX_ERR: dict[str, float] = {}
PROFILES: dict[str, dict] = {}  # path -> device_profile of one run of it
TIMES: dict[str, dict[str, dict]] = {}  # path -> kernel -> times


def settle(path: str, timed_kernels=(), keep=()) -> None:
    """Hold each kernel of the path against its plain version on the copied
    inputs of every signature the path gave it, time ``timed_kernels``
    (:func:`time_kernel`), then drop the copies (but those of the kernels
    in ``keep``)."""
    for name, sigs in CAPTURED[path].items():
        for key, (calls, (args, kw)) in sigs.items():
            err = _compare(name, args, kw)
            MAX_ERR[name] = max(MAX_ERR.get(name, 0.0), err)
            log(f"{path}: {name} {list(key)} x{calls} equals its plain version "
                f"(max |diff| {err})")
    for name in timed_kernels:
        if not CAPTURED[path].get(name):
            raise SystemExit(f"FAIL {path}: kernel {name} was never launched")
        TIMES.setdefault(path, {})[name] = time_kernel(name, path)
        log(f"{path}: {name} timed: {json.dumps(TIMES[path][name])}")
    for name, sigs in CAPTURED[path].items():
        if name not in keep:
            for entry in sigs.values():
                entry[1] = None


def _bound(name: str, args) -> tuple[float, str]:
    """Bytes each input read once and each output written once, over the
    memory rate; operations over the 32-bit rate; the larger."""
    if name == "argsort":
        n = args[0].shape[0]
        return bound(12 * n, n * math.log2(max(n, 2)))
    if name == "segmented_combine":
        st = args[0]
        n = st.capacity
        return bound(2 * n * row_bytes(st), n * (1 + sum(st.widths)))
    if name == "grouped_matmul":
        x, w = args
        e, d, f = w.shape
        nbytes = (x.numel() + w.numel() + x.shape[0] * f) * x.element_size()
        rate = BF16_TENSOR_OPS_PER_S if x.dtype.itemsize == 2 else CUDA_CORE_OPS_PER_S
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2.0 * x.shape[0] * d * f / rate
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
    if name in ("merge_absorb", "merge_absorb_bitonic"):  # the same function
        a, b = args
        n = a.capacity + b.capacity
        return bound(2 * n * row_bytes(a), n * (math.log2(max(a.capacity, 2)) + 1 +
                                                sum(a.widths)))
    a, b = args[0].shape[0], args[1].shape[0]
    return bound(8 * a + 8 * b + 5 * a, a * math.ceil(math.log2(b + 1)))


def time_kernel(name: str, path: str) -> dict:
    """Kernel, plain version and library call timed on the copied inputs of
    the signature that carried the most rows through the kernel on the
    path: calls times input rows (the probe's left rows, one thread each;
    the grouped matmul's E*C rows, and every one of its shapes timed)."""
    sigs = CAPTURED[path][name]

    def rows(k):
        if name in ("join_probe", "grouped_matmul"):  # left rows; E*C rows
            return k[0]
        return sum(x for x in k if type(x) is int)

    key = max(sigs, key=lambda k: (sigs[k][0] * rows(k), k))
    out = time_call(name, path, key)
    if name in ("grouped_matmul", "argsort"):  # every shape (decode's and prefill's)
        out["by_shape"] = [time_call(name, path, k) for k in sorted(sigs, key=str)]
    return out


def time_call(name: str, path: str, key) -> dict:
    import torch

    calls, (args, kw) = CAPTURED[path][name][key]
    mod, launch, plain, _, _ = _kernel_table()[name]

    def bmm():
        x, w = args
        e, d, _ = w.shape
        return torch.bmm(x.view(e, -1, d), w)

    library = {"argsort": lambda: torch.argsort(args[0], stable=True),
               "join_probe": lambda: torch.searchsorted(args[1], args[0]),
               "grouped_matmul": bmm}.get(name)
    b_ms, b_by = _bound(name, args)
    extra = {}
    if name == "grouped_matmul":
        x, w = args
        extra["variant"] = mod.grouped_matmul_launch(x, w, **kw)[1]
    ms, host_ms = cuda_ms(lambda: getattr(mod, launch)(*args, **kw), 20)
    return dict(
        path=path, shape=list(key), calls_at_shape=calls, **extra, ms=ms, host_ms=host_ms,
        plain_ms=cuda_ms(lambda: getattr(mod, plain)(*args, **kw), 20)[0],
        library_ms=cuda_ms(library, 20)[0] if library else None,
        bound_ms=b_ms, bound_by=b_by,
        on_card_per_call=on_card(name, key, lambda: getattr(mod, launch)(*args, **kw)),
    )


# the operations one call may put on the card: (kernels, memsets, copies);
# the argsort up to 65,536 keys one kernel, the combine two kernels and a
# memset (the bitonic foil's: on_card_design)
ON_CARD = {"argsort": (1, 0, 0), "segmented_combine": (2, 1, 0)}


def on_card_design(name: str, key):
    """(distinct kernels, memsets, copies) of one call by design: ON_CARD's,
    or the bitonic foil's, one kernel for each size of global pass its plan
    runs, the tiles and the fill, and one memset."""
    if name == "merge_absorb_bitonic":
        from repro_torch.kernels import merge_aggregate

        return len(set(merge_aggregate.plan(key[0], key[1])[2])) + 2, 1, 0
    return ON_CARD.get(name)


def on_card(name: str, key, fn, reps: int = 20) -> dict:
    """The operations one call of ``fn`` puts on the card (``torch.profiler``
    over ``reps`` calls): each one's device ms and count a call, and the
    distinct kernels, memsets and copies.  The profiler may drop events, so
    counts a call can fall below 1; the distinct operations are what a call
    launches.  Fails where a kernel of ``ON_CARD`` puts more on the card
    than its design does."""
    prof = device_profile(f"{name} {list(key)}", lambda: [fn() for _ in range(reps)], {})
    if "top_kernels" not in prof:
        return {"device_time": "not measured"}
    ops = [[op, ms / reps, count / reps] for op, ms, count in prof["top_kernels"]]
    kinds = {"memsets": sum(op.startswith("Memset") for op, _, _ in ops),
             "copies": sum(op.startswith("Memcpy") for op, _, _ in ops)}
    kinds["kernels"] = len(ops) - kinds["memsets"] - kinds["copies"]
    kinds["kernel_launches"] = sum(c for op, _, c in ops
                                   if not op.startswith(("Memset", "Memcpy")))
    want = on_card_design(name, key)
    if want and 0 < key[0] and (name != "argsort" or key[0] <= 1 << 16):
        got = (kinds["kernels"], kinds["memsets"], kinds["copies"])
        if got != want:
            raise SystemExit(f"FAIL {name} {list(key)}: (kernels, memsets, copies) a call "
                             f"{got}, the design's {want}")
    return {"ops": ops, **kinds}


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
    with capture("aggregate"):
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
    require_launches("main path", launches, AGG_KERNELS)
    info = dict(rows=n, groups=int(uk.size), wall_s=wall, rows_per_s=n / wall,
                launches=launches, host_syncs=host_syncs, max_memory_allocated=peak,
                stats=res.stats.as_dict())
    log(f"main path ok: {json.dumps(info)}")
    return info, res, (uk, cnt, sums)


def profile_aggregate(dev, rows, wall_s: float) -> dict:
    """Phase 3's aggregate once more under ``torch.profiler``: the
    merge-absorb kernels' device time summed over one SF-10 aggregate (and
    the other kernels'), beside the profiled run's wall and phase 3's."""
    import repro_torch

    cfg = repro_torch.ExecConfig(**MAIN_CFG)
    prof = device_profile("one SF-10 aggregate", lambda: repro_torch.aggregate(
        {"orderkey": rows["orderkey"]}, by=repro_torch.KeySpec.of(orderkey=26),
        values=rows["quantity"], aggs=("count", "sum"), cfg=cfg, device=dev),
        {"merge_absorb": ("merge_absorb_tiles<1,", "merge_absorb_fill<true>"),  # MA_SRC_MERGE
         "segmented_combine": ("merge_absorb_tiles<0,", "merge_absorb_fill<false>"),  # MA_SRC_A
         "argsort": ARGSORT_KERNELS})
    prof["phase3_wall_ms"] = wall_s * 1e3
    log(f"aggregate profile: {json.dumps(prof)}")
    return prof


def require_launches(path: str, launches: dict, kernels) -> None:
    for k in kernels:
        if launches[k] <= 0:
            raise SystemExit(f"FAIL {path}: kernel {k} was never launched")


def require_on_card(path: str, result) -> None:
    if result.plan["backend"] != "cuda" or result.state.device.type != "cuda":
        raise SystemExit(f"FAIL {path}: ran on {result.plan['backend']} / "
                         f"{result.state.device}")


def u64_path(dev, rng, sf=1):
    import torch

    import repro_torch

    rows, _ = lineitem(sf, rng, part_supp=True)
    by = repro_torch.KeySpec.of(partkey=21, suppkey=17)
    t0 = time.perf_counter()
    with capture("u64 aggregate"):
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
    uk, cnt, sums = oracle(packed, rows["quantity"])
    check_equal("Q20 keys", by.pack({"partkey": rel["partkey"], "suppkey": rel["suppkey"]}), uk)
    check_equal("Q20 sums", rel["sum"][:, 0].astype(np.float64), sums)
    info = dict(rows=int(packed.size), groups=int(uk.size), wall_s=wall,
                stats=res.stats.as_dict())
    log(f"u64 path ok: {json.dumps(info)}")
    return res, (uk, cnt, sums)


def spill_parity(dev, rows) -> None:
    """2^20 SF-10 rows at M = 2^14 (spills, pre-merge and merge levels)
    through the card and through the port's plain CPU path, by every
    policy and algorithm: equal states and ``SpillStats``."""
    from repro_torch.core import pipeline
    from repro_torch.core.types import ExecConfig, state_to_numpy

    n = 1 << 20
    keys, qty = rows["orderkey"][:n], rows["quantity"][:n]
    cfg = ExecConfig(**SPILL_CFG)
    entries = {"rs": lambda d: pipeline.insort_aggregate_device(keys, qty, cfg,
                                                                output_estimate=n, device=d)}
    entries.update({name: (lambda d, fn=fn: fn(keys, qty, cfg, d, n))
                    for name, (_, fn) in baselines().items()})
    for name, run in entries.items():
        got = {}
        for d in (dev, "cpu"):
            t0 = time.perf_counter()
            with capture("spill parity"):
                state, stats = run(d)
            got[d] = (state_to_numpy(state), stats.as_dict(), time.perf_counter() - t0)
            del state
        (sa, da, ta), (sb, db, tb) = got[dev], got["cpu"]
        for f in sa:
            check_equal(f"spill parity {name} {f}", sa[f], sb[f])
        if da != db:
            raise SystemExit(f"FAIL spill parity {name}: SpillStats differ\n{da}\n{db}")
        if name != "inmemory" and da["total_spill_rows"] == 0:
            raise SystemExit(f"FAIL spill parity {name}: the input did not spill: {da}")
        if name == "rs" and (da["rows_spilled_merge"] == 0 or da["runs_generated"] < 2):
            raise SystemExit(f"FAIL spill parity: the input did not spill through pre-merge: {da}")
        info = dict(path=name, rows=n, stats=da, card_s=ta, cpu_s=tb)
        log(f"spill parity ok: {json.dumps(info)}")


# ---------------------------------------------------------------------------
# phases 6-7: the order-consuming join path
# ---------------------------------------------------------------------------


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def join_path(dev, L, q18, lines, rng, sf=10) -> dict:
    """TPC-H ``orders`` at SF 10 (spec §4.2.3): the sparse keys of
    ``lineitem``, ``o_orderdate`` uniform over days 0..2405 after
    1992-01-01, a seeded float32 ``o_totalprice``.  Per line, ship = order
    + s, commit = order + c, receipt = ship + r with s ~ U[1,121], c ~
    U[30,90], r ~ U[1,30], so ``l_commitdate < l_receiptdate`` exactly when
    c < s + r."""
    import torch

    import repro_torch
    from repro_torch.core.join import join_aggregate
    from repro_torch.core.types import keys_to_numpy
    from repro_torch.kernels import ops

    by = repro_torch.KeySpec.of(orderkey=26)
    cfg = repro_torch.ExecConfig(**MAIN_CFG)
    i = np.arange(int(1_500_000 * sf), dtype=np.int64)
    okey = ((i // 8) * 32 + (i % 8) + 1).astype(np.uint32)
    odate = rng.integers(0, 2406, okey.size).astype(np.int16)
    price = (rng.integers(90_000, 50_000_000, okey.size) / 100).astype(np.float32)
    perm = rng.permutation(okey.size)
    n = lines["orderkey"].size
    s, c, r = (rng.integers(lo, hi + 1, n, dtype=np.int16)
               for lo, hi in ((1, 121), (30, 90), (1, 30)))
    late = c < s + r
    in_q = (odate[perm] >= Q4_DAYS[0]) & (odate[perm] < Q4_DAYS[1])

    def agg(keys, values=None, aggs=("count",)):
        return repro_torch.aggregate({"orderkey": keys}, by=by, values=values, aggs=aggs,
                                     cfg=cfg, device=dev)

    with capture("join inputs"):
        (O, W, C), agg_s = timed(lambda: (agg(okey[perm], price[perm], ("sum",)),
                                          agg(okey[perm][in_q]), agg(lines["orderkey"][late])))
    ops.reset_launch_counts()
    with capture("merge_join"):
        J, inner_s = timed(lambda: O.merge_join(L))
        semi, semi_s = timed(lambda: W.merge_join(C, how="semi"))
        anti, anti_s = timed(lambda: W.merge_join(C, how="anti"))
    launches = dict(ops.LAUNCHES)
    require_launches("join path", launches, ("join_probe",))
    require_on_card("join path", J)

    uk, cnt, sums = q18
    rel = J.relation()
    check_equal("Q18 join keys", rel["orderkey"], uk)
    check_equal("Q18 join count_right", rel["count_right"], cnt)
    check_equal("Q18 join sum_right", rel["sum_right"][:, 0].astype(np.float64), sums)
    check_equal("Q18 join sum_left", rel["sum_left"][:, 0], price)
    check_equal("Q18 join_count", rel["join_count"], cnt.astype(np.float32))
    present = np.zeros(int(okey[-1]) + 1, dtype=bool)
    present[lines["orderkey"][late]] = True
    wkeys = np.sort(okey[perm][in_q])
    got_semi, got_anti = semi.relation()["orderkey"], anti.relation()["orderkey"]
    check_equal("Q4 semi join", got_semi, wkeys[present[wkeys]])
    check_equal("Q4 anti join", got_anti, wkeys[~present[wkeys]])
    if np.intersect1d(got_semi, got_anti).size or got_anti.size == 0:
        raise SystemExit("FAIL Q4: semi and anti joins overlap, or the anti join is empty")
    check_equal("Q4 semi ∪ anti", np.union1d(got_semi, got_anti), W.relation()["orderkey"])
    del O, W, C, J, semi, anti
    settle("join inputs")
    settle("merge_join", ("join_probe",))

    # Q18's join by one mixed sort of orders and lineitem
    ops.reset_launch_counts()
    with capture("join_aggregate"):
        (res, _), mixed_s = timed(lambda: join_aggregate(
            okey[perm], lines["orderkey"], right_payload=lines["quantity"], by=by, cfg=cfg,
            device=dev))
    mixed_launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require_launches("join_aggregate", mixed_launches, AGG_KERNELS)
    keys = keys_to_numpy(res["keys"], res["key_dtype"])
    live = keys != np.iinfo(np.uint32).max
    check_equal("Q18 mixed-sort keys", keys[live], uk)
    for col, want in (("n_left", np.ones_like(cnt)), ("n_right", cnt), ("join_count", cnt),
                      ("sum_right_pay", sums)):
        got = res[col].detach().cpu().numpy()[live]
        check_equal(f"Q18 mixed-sort {col}", got.reshape(len(uk)).astype(np.float64), want)
    del res
    settle("join_aggregate", AGG_KERNELS)
    info = dict(orders=int(okey.size), q4_orders=int(wkeys.size), late_lines=int(late.sum()),
                aggregate_s=agg_s, inner_rows=int(rel["orderkey"].size), inner_s=inner_s,
                semi_rows=int(got_semi.size), semi_s=semi_s, anti_rows=int(got_anti.size),
                anti_s=anti_s, launches=launches, join_aggregate_rows=int(okey.size + n),
                join_aggregate_s=mixed_s, join_aggregate_launches=mixed_launches,
                max_memory_allocated=peak)
    log(f"join path ok: {json.dumps(info)}")
    return launches, mixed_launches


def pipeline_path(dev, L20, q20, rng, sf=1) -> dict:
    """SF-1 ``partsupp`` (spec §4.2.3: 4 suppliers a part, ``ps_availqty``
    ~ U[1,9999]) joined with phase 4's per-(part, supplier) aggregate and
    rolled up to ``partkey`` and the grand total, in one pipeline."""
    import repro_torch
    from repro_torch.kernels import ops

    by = L20.by
    P, S = int(200_000 * sf), int(10_000 * sf)
    partkey = np.repeat(np.arange(1, P + 1, dtype=np.int64), 4)
    j = np.tile(np.arange(4, dtype=np.int64), P)
    suppkey = (partkey + j * (S // 4 + (partkey - 1) // S)) % S + 1
    avail = rng.integers(1, 10_000, partkey.size).astype(np.float32)
    perm = rng.permutation(partkey.size)
    cols = {"partkey": partkey[perm].astype(np.uint32), "suppkey": suppkey[perm].astype(np.uint32)}
    with capture("pipeline inputs"):
        PS = repro_torch.aggregate(cols, by=by, values=avail[perm], aggs=("sum",),
                                   cfg=repro_torch.ExecConfig(**MAIN_CFG), device=dev)
    ops.reset_launch_counts()
    with capture("pipeline"):
        out, wall = timed(lambda: repro_torch.pipeline(
            [L20, ("merge_join", {"right": PS}), ("rollup", {"levels": [1, 0]})]))
    launches = dict(ops.LAUNCHES)
    require_launches("pipeline", launches, ("join_probe", "segmented_combine"))
    for tier in out.values():
        require_on_card("pipeline", tier)
    want_block = {"stages": ["aggregate", "merge_join[inner]", "rollup"], "source_sorts": 2,
                  "re_sorts": 0}
    for names, tier in out.items():
        if tier.plan["pipeline"] != want_block:
            raise SystemExit(f"FAIL pipeline plan {names}: {tier.plan['pipeline']}")
    # oracle: every (part, supplier) of lineitem is a partsupp row
    uk, lcnt, lsum = q20
    ps_uk, ps_inv, ps_cnt = np.unique(by.pack({"partkey": partkey, "suppkey": suppkey}),
                                      return_inverse=True, return_counts=True)
    at = np.minimum(np.searchsorted(ps_uk, uk), ps_uk.size - 1)
    check_equal("Q20 keys found in partsupp", ps_uk[at], uk)
    rcnt = ps_cnt[at]
    rsum = np.bincount(ps_inv, weights=avail.astype(np.float64))[at]
    pk = (uk >> np.uint64(by.shift_of("partkey"))).astype(np.int64)
    upk, inv = np.unique(pk, return_inverse=True)
    rel = out[("partkey",)].relation()
    check_equal("pipeline partkey level keys", rel["partkey"], upk)
    check_equal("pipeline partkey join_count", rel["join_count"].astype(np.float64),
                np.bincount(inv, weights=lcnt * rcnt))
    check_equal("pipeline partkey sum_left", rel["sum_left"][:, 0].astype(np.float64),
                np.bincount(inv, weights=lsum))
    check_equal("pipeline partkey sum_right", rel["sum_right"][:, 0].astype(np.float64),
                np.bincount(inv, weights=rsum))
    total = out[()].relation()
    check_equal("pipeline total join_count", total["join_count"],
                np.float32([(lcnt * rcnt).sum()]))
    # the grand totals of the sums pass 2^24 and round in float32: the repo's
    # float tolerance, rtol 1e-4
    for col, want in (("sum_left", lsum.sum()), ("sum_right", rsum.sum())):
        got = float(total[col][0, 0])
        if not abs(got - want) <= 1e-4 * abs(want):
            raise SystemExit(f"FAIL pipeline total {col}: {got} vs {want} (rtol 1e-4)")
    info = dict(partsupp_rows=int(partkey.size), join_rows=int(uk.size),
                partkey_groups=int(upk.size), wall_s=wall, launches=launches)
    log(f"pipeline ok: {json.dumps(info)}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the bitonic foil on phase 3's merge-absorb inputs
# ---------------------------------------------------------------------------


def foil_path() -> dict:
    """Replay every merge-absorb input phase 3 gave the merge-path kernel
    through the bitonic merge-absorb; each result must equal the merge-path
    kernel's exactly (integer payloads).  Both kernels timed on the inputs
    of the shape that carried most rows on phase 3."""
    from repro_torch.kernels import merge_path, ops
    from repro_torch.kernels.merge_aggregate import next_pow2, plan

    sigs = CAPTURED["aggregate"]["merge_absorb"]
    ops.reset_launch_counts()
    with capture("bitonic foil"):
        outs = {key: ops.merge_absorb_sorted_bitonic(*args)
                for key, (_, (args, _)) in sigs.items()}
        _sync()
    launches = dict(ops.LAUNCHES)
    require_launches("bitonic foil", launches, ("merge_absorb_bitonic",))
    for key, (_, (args, kw)) in sigs.items():
        state_diff(f"bitonic foil {list(key)} vs merge path", outs.pop(key),
                   merge_path.merge_absorb_cuda(*args, **kw))
    foil = CAPTURED["bitonic foil"]["merge_absorb_bitonic"]
    for key in sigs:  # timed where phase 3 sent most rows: phase 3's call counts
        foil[key[:3]][0] = 0
    for key, (calls, _) in sigs.items():
        foil[key[:3]][0] += calls
    settle("bitonic foil", ("merge_absorb_bitonic",))
    t = TIMES["bitonic foil"]["merge_absorb_bitonic"]
    busiest = max((k for k in sigs if list(k[:3]) == t["shape"]), key=lambda k: sigs[k][0])
    _, (args, kw) = sigs[busiest]
    t["merge_path_ms"] = cuda_ms(lambda: merge_path.merge_absorb_cuda(*args, **kw), 20)[0]
    # the rows the reference pads both sides to, and the kernel's network
    t["padded_rows"] = 2 * next_pow2(max(busiest[0], busiest[1]))
    t["m"], _, t["passes"] = plan(busiest[0], busiest[1])
    for sig in sigs.values():
        sig[1] = None
    info = dict(replayed_shapes=[list(k) for k in sigs], launches=launches, timed=t)
    log(f"bitonic foil ok: {json.dumps(info)}")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the serve path of the sorted-dispatch MoE model
# ---------------------------------------------------------------------------


def _sync() -> None:
    import torch

    torch.cuda.synchronize()


@contextlib.contextmanager
def routes():
    """Record the expert ids every MoE router call chose (host copies)."""
    from repro_torch.models import moe

    seen, orig = [], moe._router

    def tap(*args, **kw):
        out = orig(*args, **kw)
        seen.append(out[0].cpu())
        return out

    moe._router = tap
    try:
        yield seen
    finally:
        moe._router = orig


def _bmm_products(x, w, *, capacity: int):
    """``torch.bmm`` in place of the grouped-matmul kernel: the same
    function, float32 sums (no reduced-precision reduction) rounded once."""
    import torch

    e, d, f = w.shape
    mm = torch.backends.cuda.matmul
    flag, mm.allow_bf16_reduced_precision_reduction = (
        mm.allow_bf16_reduced_precision_reduction, False)
    try:
        return torch.bmm(x.view(e, capacity, d), w).view(e * capacity, f)
    finally:
        mm.allow_bf16_reduced_precision_reduction = flag


@contextlib.contextmanager
def library_products():
    """The ``cuda`` backend with ``torch.bmm`` in place of the grouped-matmul
    kernel (every other kernel as it is): the witness of what a second,
    equally exact product does to the served model.  Yields a one-element
    list that counts the products."""
    import dataclasses

    from repro_torch.core import dispatch

    be, calls = dispatch.get_backend("cuda", "cuda"), [0]

    def products(x, w, *, capacity):
        calls[0] += 1
        return _bmm_products(x, w, capacity=capacity)

    dispatch._cache["cuda"] = dataclasses.replace(be, grouped_matmul=products)
    try:
        yield calls
    finally:
        dispatch._cache["cuda"] = be


def route_share(ra, rb) -> float:
    """The share of (token, layer, slot) routes two serve runs agree on."""
    return float(np.mean(np.concatenate(
        [(x == y).numpy().reshape(-1) for x, y in zip(ra, rb)])))


def serve_pair(model, cfg, prompts, capture_as: str):
    """Serve ``prompts`` with the kernels (under ``capture``), then with
    the plain versions on the same weights, teacher-forced with the
    kernels' tokens.  Returns both generations, the launches of the kernel
    run and both runs' routes."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate

    kw = dict(gen=SERVE["gen"], max_len=SERVE["prompt_len"] + SERVE["gen"], keep_logits=True)
    ops.reset_launch_counts()
    with capture(capture_as), routes() as ra:
        a = generate(model, cfg, prompts, backend="cuda", **kw)
    launches = dict(ops.LAUNCHES)
    with routes() as rb:
        b = generate(model, cfg, prompts, backend="torch", force=a.tokens[:, :-1], **kw)
    return a, b, launches, ra, rb


def device_profile(window: str, fn, kernels: dict) -> dict:
    """Device time by kernel while ``fn`` runs (``torch.profiler``, the
    device traced alone), beside the host clock: the device's busy time and
    idle share, the top kernels, and for each entry of ``kernels`` (label
    -> substrings of kernel names) the summed self device time and calls of
    the kernels it names.  "not measured" where the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def self_device_us(evt) -> float:
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, attr):
                return float(getattr(evt, attr))
        return 0.0

    # device rows only: the runtime's API calls (cudaLaunchKernel, ...) are host rows
    rows = sorted(((self_device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CPU), reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    if busy_ms == 0:
        return {"window": window, "wall_ms": wall_ms, "device_time": "not measured"}
    by_label = {}
    for label, parts in kernels.items():
        hit = [(us, count) for us, name, count in rows if any(p in name for p in parts)]
        ms = sum(us for us, _ in hit) / 1e3
        by_label[label] = {"device_ms": ms, "calls": sum(c for _, c in hit),
                           "share_of_busy": ms / busy_ms}
    return {"window": window, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms, "kernels": by_label,
            "top_kernels": [[name[:80], us / 1e3, count] for us, name, count in rows[:10]]}


def profile_serve(model, cfg, prompts) -> dict:
    """Device time by kernel over a prefill and two decode steps: where the
    serve step's time goes, the grouped matmul's share of it, and the
    device's idle share."""
    from repro_torch.launch.serve import generate

    return device_profile(
        "prefill + 2 decode steps",
        lambda: generate(model, cfg, prompts, gen=3, max_len=SERVE["prompt_len"] + 3,
                         backend="cuda"),
        {"grouped_matmul": ("grouped_matmul",), "argsort": ARGSORT_KERNELS})


def serve_path(dev) -> dict:
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(SERVE["arch"])
    b, s, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(SEED))

    # gate (b): 2 layers at full width in float32, kernels against plain
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model = M.init(cfg2, torch.Generator(device=dev).manual_seed(SEED))
    a, p, _, ra, rb = serve_pair(model, cfg2, prompts, "serve fp32")
    del model
    if len(ra) != len(rb) or not all(torch.equal(x, y) for x, y in zip(ra, rb)):
        raise SystemExit("FAIL serve fp32: the kernels and the plain versions routed "
                         "tokens to different experts")
    if not np.allclose(a.logits, p.logits, rtol=1e-3, atol=1e-3):
        raise SystemExit(f"FAIL serve fp32: logits differ by {np.abs(a.logits - p.logits).max()}"
                         " (rtol/atol 1e-3)")
    check_equal("serve fp32 greedy tokens", a.tokens, p.tokens)
    fp32 = dict(layers=2, max_abs_logit_diff=float(np.abs(a.logits - p.logits).max()),
                router_calls=len(ra))
    log(f"serve fp32 (2 layers, full width) ok: {json.dumps(fp32)}")
    settle("serve fp32")
    torch.cuda.empty_cache()

    # gate (c): all 48 layers in bfloat16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    _sync()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size() for t in model.parameters())
    a, p, launches, ra, rb = serve_pair(model, cfg, prompts, "serve")
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(a.logits).all():
        raise SystemExit("FAIL serve: non-finite logits")
    steps, layers = gen, cfg.n_layers
    # every bfloat16 product on the tensor-core variant, none on the CUDA cores
    want = {"grouped_matmul": 3 * layers * steps, "grouped_matmul_simt": 0,
            "argsort": layers * steps}
    require_launches("serve", launches, ("grouped_matmul", "argsort"))
    if any(launches[k] != v for k, v in want.items()):
        raise SystemExit(f"FAIL serve: launches {launches}, expected {want}")
    same_routes = route_share(ra, rb)
    same_top1 = float(np.mean(a.tokens == p.tokens))
    # the witness: torch.bmm for the grouped matmul, on the same forced tokens
    ops.reset_launch_counts()
    with routes() as rc, library_products() as products:
        c = generate(model, cfg, prompts, backend="cuda", force=a.tokens[:, :-1],
                     gen=gen, max_len=s + gen, keep_logits=True)
    if products[0] != want["grouped_matmul"] or ops.LAUNCHES["grouped_matmul"]:
        raise SystemExit(f"FAIL serve witness: {products[0]} torch.bmm products and "
                         f"{ops.LAUNCHES['grouped_matmul']} kernel launches, expected "
                         f"{want['grouped_matmul']} and 0")
    witness = dict(equal_route_share=route_share(rc, rb),
                   equal_top1_share=float(np.mean(c.tokens == p.tokens)),
                   max_abs_logit_diff=float(np.abs(c.logits - p.logits).max()),
                   kernel_equal_route_share=route_share(ra, rc),
                   kernel_max_abs_logit_diff=float(np.abs(a.logits - c.logits).max()))
    info = dict(
        arch=cfg.name, layers=layers, dtype=cfg.dtype, batch=b, prompt_len=s, gen=gen,
        weight_bytes=weights, param_count=cfg.param_count(), init_s=init_s,
        prefill_s=a.t_prefill, decode_ms_per_token=a.t_decode * 1e3,
        decode_tokens_per_s=b / a.t_decode,
        generated_tokens_per_s=b * gen / (a.t_prefill + (gen - 1) * a.t_decode),
        plain_prefill_s=p.t_prefill, plain_decode_ms_per_token=p.t_decode * 1e3,
        max_memory_allocated=peak, launches=launches,
        max_abs_logit_diff=float(np.abs(a.logits - p.logits).max()),
        equal_top1_share=same_top1, equal_route_share=same_routes,
        library_witness=witness, fp32_gate=fp32,
        profile=profile_serve(model, cfg, prompts))
    PROFILES["serve"] = info["profile"]
    log(f"serve: {json.dumps(info)}")
    for what, mine in (("route", same_routes), ("top1", same_top1)):
        lib = witness[f"equal_{what}_share"]
        if mine < lib - WITNESS_SLACK:
            raise SystemExit(f"FAIL serve bf16: the kernel agrees with the plain versions on "
                             f"{mine:.4f} of {what}s, torch.bmm on {lib:.4f} (slack "
                             f"{WITNESS_SLACK})")
    del model
    settle("serve", ("grouped_matmul", "argsort"))
    torch.cuda.empty_cache()
    log("serve ok")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the paper's baselines on SF-10 Q18
# ---------------------------------------------------------------------------


def baselines() -> dict:
    """The paper's baselines and the in-sort operator's other plans, name ->
    (the kernels a run must launch, ``f(keys, qty, cfg, device, estimate)
    -> (state, stats)``, ``estimate`` the output estimate that plans the
    pre-merge levels): the device pipeline's three other policies, the host loop
    (replacement selection, read-sort-write early aggregation, and
    replacement selection with traditional merges instead of the wide
    merge), and the front door's other algorithms.  Each carries Q18's
    count and sum, as the main path does."""
    import repro_torch
    from repro_torch.core import insort, pipeline

    sum_only = (1, 0, 0)

    def device(policy):
        return lambda k, q, cfg, d, est: pipeline.insort_aggregate_device(
            k, q, cfg, policy=policy, widths=sum_only, output_estimate=est, device=d)

    def host(policy, wide=True):
        return lambda k, q, cfg, d, est: insort.insort_aggregate(
            k, q, cfg, pipeline="host", run_policy=policy, use_wide_merge=wide,
            widths=sum_only, output_estimate=est, device=d)

    def front_door(algorithm, order_by=None):
        def run(k, q, cfg, d, est):
            res = repro_torch.aggregate({"orderkey": k}, by=repro_torch.KeySpec.of(orderkey=26),
                                        values=q, aggs=("count", "sum"), algorithm=algorithm,
                                        order_by=order_by, cfg=cfg, output_estimate=est,
                                        device=d)
            return res.state, res.stats
        return run

    merge = ("argsort", "merge_absorb")
    return {
        "traditional": (merge, device("traditional")),
        "inrun_dedup": (AGG_KERNELS, device("inrun_dedup")),
        "early_agg": (AGG_KERNELS, device("early_agg")),
        "host rs": (AGG_KERNELS, host("rs")),
        "host early_agg": (AGG_KERNELS, host("early_agg")),
        "host rs, traditional merge": (AGG_KERNELS, host("rs", wide=False)),
        "sort_then_stream": (merge, front_door("sort_then_stream")),
        "hash": (AGG_KERNELS, front_door("hash")),
        "f1_hash": (AGG_KERNELS, front_door("f1_hash")),
        "inmemory": (("argsort", "segmented_combine"), front_door("inmemory")),
        "hash, order_by": (AGG_KERNELS, front_door("hash", order_by=True)),
    }


def state_relation(state):
    """A Q18 state's live (keys, counts, sums) on the host, in its row order."""
    from repro_torch.core.types import keys_to_numpy

    keys = keys_to_numpy(state.keys, state.key_dtype)
    live = keys != np.iinfo(keys.dtype).max
    return (keys[live], state.count.cpu().numpy()[live],
            state.sum[:, 0].cpu().numpy().astype(np.float64)[live])


def check_q18(name: str, state, q18, *, hash_order: bool) -> None:
    """Equal to the NumPy oracle exactly; a hash result as a set, and its
    rows in hash order."""
    from repro_torch.core.hash_agg import _np_hash

    keys, cnt, sums = state_relation(state)
    if hash_order:
        h = _np_hash(keys)
        if not bool(np.all(h[1:] > h[:-1])):
            raise SystemExit(f"FAIL {name}: the rows are not in hash order")
        order = np.argsort(keys)
        keys, cnt, sums = keys[order], cnt[order], sums[order]
    uk, ucnt, usums = q18
    check_equal(f"{name} keys", keys, uk)
    check_equal(f"{name} counts", cnt, ucnt)
    check_equal(f"{name} sums", sums, usums)


# the baselines whose argsort calls are timed: the large class at 2^20 keys
# (a traditional batch) and at the SF-10 row count (the in-memory sort)
TIMED_ARGSORT = ("traditional", "inmemory")


def baselines_path(dev, rows, q18, rng, by_path: dict, main: dict) -> dict:
    """Phase 10: every baseline on SF-10 Q18 (phase 3's rows and cfg) and
    ``intersect_distinct`` of its order keys against ``orders``', each held
    to the NumPy oracle, with its kernels' launches, wall, rows/s, host
    syncs, peak device memory and ``SpillStats``."""
    import torch

    import repro_torch
    from repro_torch.core import operators
    from repro_torch.core.types import SYNCS, keys_to_numpy
    from repro_torch.kernels import ops

    cfg = repro_torch.ExecConfig(**MAIN_CFG)
    keys, qty = rows["orderkey"], rows["quantity"]
    n = keys.size
    summary = {}

    def run(path, kernels, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        SYNCS["host_syncs"] = 0
        with capture(path):
            out, wall = timed(fn)
        launches = dict(ops.LAUNCHES)
        by_path[path] = launches
        require_launches(path, launches, kernels)
        return out, dict(wall_s=wall, rows_per_s=n / wall, host_syncs=SYNCS["host_syncs"],
                         max_memory_allocated=torch.cuda.max_memory_allocated(),
                         launches=launches)

    for name, (kernels, fn) in baselines().items():
        path = f"baseline {name}"
        (state, stats), info = run(path, kernels, lambda: fn(keys, qty, cfg, dev, None))
        if state.device.type != "cuda":
            raise SystemExit(f"FAIL {path}: ran on {state.device}")
        check_q18(path, state, q18, hash_order=name in ("hash", "f1_hash"))
        del state
        info.update(rows=n, stats=stats.as_dict())
        summary[name] = dict(wall_s=info["wall_s"], spill_rows=stats.total_spill_rows,
                             host_syncs=info["host_syncs"])
        log(f"{path} ok: {json.dumps(info)}")
        settle(path, ("argsort",) if name in TIMED_ARGSORT else ())

    # Q18's order keys intersected with those of orders (phase 6's table):
    # every order has a line, so the intersection is every order key
    i = np.arange(15_000_000, dtype=np.int64)
    okeys = ((i // 8) * 32 + (i % 8) + 1).astype(np.uint32)[rng.permutation(i.size)]
    path = "baseline intersect_distinct"
    (common, stats), info = run(path, AGG_KERNELS + ("join_probe",),
                                lambda: operators.intersect_distinct(keys, okeys, cfg, device=dev))
    got = keys_to_numpy(common, np.uint32)
    check_equal(f"{path} keys", got[got != np.iinfo(np.uint32).max], q18[0])
    del common
    info.update(rows=n + okeys.size, stats=stats.as_dict())
    log(f"{path} ok: {json.dumps(info)}")
    settle(path)
    summary["insort (phase 3, rs)"] = dict(wall_s=main["wall_s"],
                                          spill_rows=main["stats"]["total_spill_rows"],
                                          host_syncs=main["host_syncs"])
    log(f"baselines side by side (SF-10 Q18, {n} rows): {json.dumps(summary)}")
    return summary


def kernel_records(by_path: dict) -> list[dict]:
    """The kernels' JSON records: each kernel timed and counted on its own
    path, the aggregate's (phase 3) for the aggregate kernels, the merge
    joins' (phase 6) for the probe, the foil's (phase 8) for the bitonic
    merge-absorb, the serve path's (phase 9) for the grouped matmul, with
    its times on the other paths beside and every shape it was checked at."""
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path = RECORD_PATH.get(name, "aggregate")
        t = TIMES[path][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=by_path[path][name], max_abs_err=MAX_ERR[name], max_abs_diff=MAX_ERR[name],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], path=path,
            **{k: t[k] for k in ("host_ms", "by_shape", "merge_path_ms", "padded_rows", "m",
                                 "passes", "variant", "on_card_per_call") if k in t},
            **({"launches_simt": by_path[path]["grouped_matmul_simt"]}
               if name == "grouped_matmul" else {}),
            device_time_on_path=PROFILES.get(path, {}).get("kernels", {}).get(name),
            other_shapes=[v[name] for p, v in TIMES.items() if p != path and name in v],
            launches_by_path={p: v[name] for p, v in by_path.items()},
            checked_shapes={p: [list(k) + [calls] for k, (calls, _) in sigs[name].items()]
                            for p, sigs in CAPTURED.items() if sigs.get(name)},
        ))
    return kernels


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
    t0 = t_start = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s")
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if "Used" in line:
                log(f"ptxas {name}: {line.strip()}")

    check_kernels(dev, B=MAIN_CFG["batch_rows"], M=MAIN_CFG["memory_rows"],
                  P=MAIN_CFG["page_rows"])

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    rows, ordered = lineitem(10, rng, part_supp=False)
    log(f"SF10 lineitem: {rows['orderkey'].size} rows made in {time.perf_counter() - t0:.1f} s")
    main, L, q18 = main_path(dev, rows, ordered)
    settle("aggregate", AGG_KERNELS, keep=("merge_absorb",))  # phase 8 replays them
    PROFILES["aggregate"] = profile_aggregate(dev, rows, main["wall_s"])
    del ordered
    L20, q20 = u64_path(dev, rng)
    settle("u64 aggregate")
    spill_parity(dev, rows)
    settle("spill parity")
    by_path = {"aggregate": main["launches"]}
    by_path["merge_join"], by_path["join_aggregate"] = join_path(dev, L, q18, rows, rng)
    del L
    by_path["pipeline"] = pipeline_path(dev, L20, q20, rng)
    del L20
    settle("pipeline inputs")
    settle("pipeline", ("join_probe", "segmented_combine"))
    by_path["bitonic foil"] = foil_path()
    gc.collect()
    torch.cuda.empty_cache()  # the serve path needs ~62 of the card's 80 GB
    by_path["serve"] = serve_path(dev)
    gc.collect()
    torch.cuda.empty_cache()
    baselines_path(dev, rows, q18, rng, by_path, main)
    kernels = kernel_records(by_path)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

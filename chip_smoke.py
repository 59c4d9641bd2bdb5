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
   the four serve shapes, deepseek-v3's four in bfloat16 (256 experts,
   7168 -> 2048 and 2048 -> 7168 at C = 8 and 40), capacities 8 to 264 and
   widths that are no multiple of 64, on the variant its dtype and widths
   call for, ``torch.bmm`` beside the serve shapes; its backward, two more
   launches of the kernel, at the training shapes (E = 128, C = 128, 2048
   -> 768 and back, bfloat16 and float32) against the float32 products and
   the plain version's autograd gradients, timed beside ``torch.bmm``'s);
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
   model is served the same two ways (its shares of routes and greedy
   tokens equal logged; the third serve with ``torch.bmm`` in place of the
   kernel, PRs 14-23's witness, is cut for time since PR 24): its logits
   must be finite; every grouped-matmul shape lies within one bfloat16 ulp of
   the float32 product plus float32's own bound for summing in another
   order (``gmm_tolerance``);
10. the paper's baselines on phase 3's SF-10 Q18 rows and configuration:
   the device pipeline's ``traditional``, ``inrun_dedup`` and
   ``early_agg`` policies; the host loop (``pipeline="host"``) with
   replacement selection, with read-sort-write early aggregation, and
   with traditional merges in place of the wide merge; the front door's
   ``sort_then_stream``, ``f1_hash`` and ``inmemory`` algorithms and
   ``hash`` with ``order_by`` (plain ``hash`` only at phase 5's 2^20
   rows, cut for time); ``intersect_distinct`` of
   the order keys against phase 6's ``orders``.  Each must equal the
   NumPy oracle exactly (a hash result as a set, its rows in hash order)
   and launch its kernels; each logs its wall, rows/s, host syncs, peak
   device memory and ``SpillStats``, and one line puts them side by side
   with phase 3's in-sort run.  The argsort's large class is timed at
   2^20 keys (a traditional batch) and at the SF-10 row count (the
   in-memory sort), beside ``torch.argsort``;
11. the streamed path: a) phase 3's rows as 15 column batches of 2^22
   rows (``repro_torch.data.pipeline.iter_column_batches``) through
   ``repro_torch.aggregate(algorithm="insort")``, equal to phase 3's rows
   and ``SpillStats``; b) the same batches with ``algorithm="auto"``
   (adaptive), equal to the oracle, with its arms, events and readbacks
   logged; c) ``benchmarks/bench_adaptive.py``'s phase-change streams
   (33,554,432 rows, both orders) through adaptive and each fixed arm,
   each equal to the oracle, with each phase's wall; d) a phase-change
   stream of 2^20 rows at the spill-parity ``ExecConfig`` with a governor
   made to switch, through the card and the plain CPU path: equal
   states, ``SpillStats`` and policy events, at least one switch, a
   snapshot that leaves every engine tensor byte-identical, and an
   eviction that retires the same rows on both;
12. aggregation as a service: a) phase 11a's column batches through
   ``repro_torch.serve_aggregate`` (``rs``), snapshots after batches 5 and
   10 equal to the oracle of their prefix and leaving every engine tensor
   byte-identical, ``expire_below`` at the prefix's 25th-percentile order
   key retiring as many rows as NumPy counts in the engine below it, the
   close equal to the oracle of the rows not retired; b)
   ``launch/serve_agg.py``'s drifting traffic (64 chunks of 2^20 rows, key
   space 2^20) through ``AggregationService`` with ``rs`` and with
   ``adaptive`` under the card's committed constants, a snapshot every 8
   chunks after a TTL-2 eviction, with ingest rows/s, snapshot p50/p99,
   host syncs, arms and the plan's ``calibrated_backend`` (which must read
   ``cuda``), the close equal to the oracle of the rows not retired (normal
   payloads: sums within 2 n 2^-24 sum|x|, and the kernels within the same
   bound of their plain versions); c) ``python -m
   repro_torch.launch.serve_agg --smoke``;
13. distributed aggregation: 4 ranks (``torch.multiprocessing`` processes
   joined over gloo, sharing the card; each reads its slice of NumPy files
   this script wrote, by ``mmap``): a) phase 3's SF-10 Q18 through
   ``repro_torch.aggregate(mesh=)``, the ranks' shards concatenated equal
   to the oracle exactly, rank r's keys below rank r+1's, ``SpillStats``
   equal on every rank, fewer rows exchanged than the input holds, with
   each rank's wall, host syncs, peak memory and launches; b) phase 6's
   Q18 merge join and Q4 semi and anti joins with both sides aggregated
   on the mesh (``merge_join(mesh=)``), equal to phase 6's joins; c)
   ``serve_agg``'s drifting traffic cut to 16 chunks of 2^20 rows through a
   mesh stream and a mesh ``AggregationService`` (``rs``, a snapshot every
   4 chunks after the TTL-2 eviction, every engine tensor byte-identical
   across it; the close), each equal to the oracle of the rows not
   retired; d) 2^20 SF-10 rows at the spill-parity ``ExecConfig`` on the
   card and on CPU ranks over the same gloo group: equal rows and
   ``SpillStats``, which equal the ranks' one-device runs reduced but for
   the exchange's fields; e) ``python -m repro_torch.launch.shard_agg
   --world 4 --dist-backend gloo`` at 2^23 rows, Zipf s = 1.2, against its
   oracle, and its ``--smoke``.  Each rank counts its kernels' launches
   from zero and fails if one never launched; rank 0 holds its kernels'
   inputs against the plain versions.  Part a runs again on NCCL, one rank
   a card, where there are two cards.
14. corpus dedup: ``SyntheticCorpus`` at llama3-8b's vocabulary (128,256)
   and 2^21 documents from the seed, every fingerprint on the card
   (``data.pipeline.fingerprints``, equal on a sample to the reference's
   one-document hash), ``dedup_examples`` under ``M = 2^16`` (runs spill
   through a pre-merge level and the wide merge): the kept documents are
   the first occurrences of ``np.unique``'s fingerprints, the
   ``SpillStats`` equal the port's CPU run on the same fingerprints; the
   kept documents packed into rows of 4,096 tokens (every token kept; a
   prefix of 2^12 documents equal to the reference's row-scan first fit);
   ``ops.sort_keys`` on 2^20 fingerprints and ``bitonic_sort`` /
   ``bitonic_sort_kv`` on a (64, 4096) batch of them, equal to their plain
   versions; the wall of each step;
15. the dense family: a) llama3-8b (``kv_dup`` 2), qwen2-1.5b (QKV bias,
   tied embeddings) and granite-20b (MQA, gelu) at full width cut to 2
   layers in float32, the card against the port's CPU run on the same
   weights, teacher-forced (prompt 32, 4 tokens): logits within rtol/atol
   1e-3, greedy tokens equal; b) each dense config in bfloat16 at full
   width, batch 4, prompt 256, 16 tokens (llama3-8b and qwen2-1.5b at
   their published depth, granite-20b cut to 26 of its 52 layers for time,
   mistral-large-123b cut to 16 of its 88 layers): finite logits, tokens inside the vocabulary, with the
   weight bytes, init, prefill, decode ms a token, tokens/s, peak memory
   and the device's idle share;
16. the example twins (``examples/torch_*.py``) at their default sizes on
   the card, each in its own process, the four at once: each must exit 0;
17. the remaining families: a) deepseek-v3-671b in bfloat16 at full width
   cut to 5 layers (its 3 dense-prefix layers with MLA, then 2 MoE layers
   of 256 experts with a shared one; MTP's weights; 54.6 GB), batch 4,
   prompt 256, 16 tokens through the kernels: 3 grouped matmuls (all on
   the tensor cores) and 1 argsort an MoE layer a step, finite logits, the
   serve's figures and the device's idle share; b) its float32 gate, a
   dense-prefix layer and an MoE layer (58.5 GB), the kernels against the
   plain versions on the card as phase 9's gate; c) mamba2-2.7b (64
   layers), zamba2-2.7b (54) and qwen2-vl-2b (28, M-RoPE, prompts as
   embeddings) served in bfloat16 at full width as phase 15b, and
   hubert-xlarge's (48) forward over 4 x 256 frame embeddings (an encoder
   has no decode step); d) float32 gates at full width, card = CPU within
   rtol/atol 1e-3: mamba2 and qwen2-vl at 2 layers served teacher-forced,
   zamba2 at 6 (one group and its shared block), hubert's forward at 2;
18. training: a) qwen3-moe-30b-a3b in bfloat16 at full width cut to 4 of
   its 48 layers (3.115 G parameters, AdamW with float32 moments, remat,
   the sorted dispatch through the kernels), 5 steps on one batch of 4 x
   512 from the ported ``DataLoader`` at lr 5e-3: finite losses and
   gradient norms, the last loss below the first, the grouped matmul's
   launches by phase (3 forward, 3 recompute, 6 backward a MoE layer a
   step) and the argsort's, the step's figures and the device's idle
   share; b) its float32 gate at 2 layers: loss and every gradient leaf
   with the kernels against the plain versions on the card (rtol 1e-5;
   1e-3 of each leaf's largest magnitude), routes equal, and the updated
   parameters after one step; c) four error-feedback rounds of
   ``compress_topk`` on 18a's embedding gradient (311,164,928 entries, k
   = 2^18), then ``aggregate_sparse`` of the 2^20 pairs through the
   argsort and the segmented combine against ``np.add.at``; d) ``python
   -m repro_torch.launch.train`` on the smoke config for 8 steps, and
   stopped at 4 then ``--resume``d: losses and the final checkpoint
   equal bit for bit; deepseek-v3's smoke config (MTP, MLA) trained 3
   steps on the card and on the CPU, within 1e-3;
19. expert parallelism: 4 ranks (``torch.multiprocessing`` processes
   joined over gloo, sharing the card) on meshes of named axes
   (``sharding.make_mesh``): a) qwen3-moe-30b-a3b in bfloat16 at full
   width cut to 12 of its 48 layers through the ``sorted_ep`` dispatch on
   data x model (1, 4), each rank drawing the one-process weights and
   keeping its 32 of 128 experts, batch 4, prompt 256, 16 greedy tokens:
   finite logits, the same tokens on every rank, every grouped matmul on
   the tensor cores, each rank's prefill, decode ms a token, peak memory,
   collectives a step and launches; b) its float32 gate at 2 layers on
   (2, 2), teacher-forced (prompt 32, 4 tokens): the kernels against the
   plain versions on the same ranks (routes equal, logits within rtol/atol
   1e-3), and at capacity factor E/k (no row drops) the forward's logits
   within rtol/atol 1e-5 of a one-process sorted run on rank 0; c) one
   float32 MoE layer at full width on (1, 4), forward and backward, every
   gradient leaf (each rank's expert slices and router columns, dx)
   within 1e-3 of its largest magnitude of the one-process sorted
   block's; d) the ring all-gather matmul, x (8192, 2048) sharded by
   sequence, w (2048, 6144), float32: within rtol/atol 1e-4 of ``x @ w``
   and of the all-gather matmul, 3 ``ppermute``s a rank and no
   all-gather, with each one's wall; e) the GPipe pipeline over 4 stages,
   8 layers of ``tanh(h @ W)`` at D = 2048, batch 64, 8 microbatches:
   output within 1e-5 and stage gradients within 1e-4 of the sequential
   model, bubble fraction 3/11.  Rank 0 holds the kernels' inputs of
   parts a-c against the plain versions; part a runs again on NCCL, one
   rank a card, where there are two cards;
20. the model half of sharding, on phase 19's ranks: every parameter and
   moment sharded by the reference's logical-axis rules
   (``distributed.fsdp``: each layer's leaves all-gathered where it runs,
   each gradient reduced to its shard): a) qwen3-moe in bfloat16 at full
   width cut to 4 layers (3.115 G parameters) on (2, 2), ``sorted_ep``
   through the kernels (every product on ``wgmma``), AdamW, 5 steps of a
   global 4 x 512 batch at lr 5e-3: losses equal on every rank and
   falling, each rank's bytes at rest equal to the spec arithmetic, ms a
   step, peak memory, collectives a step by kind and bytes, launches, and
   the H100 roofline's terms (``FlopCounterMode`` plus the grouped
   matmul's products, HBM bytes, the collectives' bytes); c) its
   parameters and every AdamW moment leaf (the expert weights' cut to
   layer 0) saved from (2, 2) and restored onto (4, 1) and (1, 4): every
   rank's shards, checksummed over the mesh, equal the saved leaves bit
   for bit; b) float32 at full width cut to 2 layers, one step, qwen3-moe
   on (2, 2) and (1, 4) and llama3-8b on (2, 2) against one process (loss
   rtol 1e-5, gradient norm rtol 1e-4, each shard of a parameter and of
   both moments within 1e-3 of the leaf's largest magnitude; an unchanged
   state and a doubled gradient on one leaf must fail those bounds), rank
   0's kernel inputs against the plain versions; d) ``launch.train.train(...,
   mesh=)`` on (2, 2), the qwen3-moe smoke config, 8 steps against 4 and a
   resume: losses and the final checkpoint bit for bit.

Every path counts its kernels' launches from zero and fails if one of its
kernels was never launched.  While a path runs, the script also copies
the first inputs of every shape it gives each kernel (``capture``); after
it, each kernel must equal its plain version on every one of them, and
the kernels are timed beside their plain versions and library calls on
the inputs of the shape that carried most rows through them (``settle``):
the aggregate kernels on phase 3's, the probe on phase 6's, the bitonic
foil on phase 8's, the grouped matmul on phase 9's, the argsort and the
grouped matmul at every shape a path gave them, with the other paths'
times beside (phase 14's key sorts, phase 17's deepseek-v3 shapes and
phase 18's training shapes, the backward's among them), and the
operations one call puts on the card (``torch.profiler``; the argsort
must be one kernel up to 65,536 keys, the combine two kernels and a
memset, and the foil its plan's).  The
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


def state_diff(name: str, a, b, sum_tol=None) -> float:
    """Raise unless keys and counts are equal; the max |difference| of the
    float planes.  Without ``sum_tol`` it must be 0: the payloads are
    integer-valued with sums below 2^24 or one value per key, so any order
    of addition is exact.  With it (phase 12b's normal payloads), the min
    and max planes must be equal and each row's sum within its
    ``sum_tol``."""
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
            if f == "sum" and sum_tol is not None and bool((d <= sum_tol).all()):
                continue
            if float(d.max()) != 0.0:
                tol = "exact" if f != "sum" or sum_tol is None else "2 count 2^-24 sum|s|"
                raise SystemExit(f"FAIL {name}: {f} planes differ by {float(d.max())} "
                                 f"(tolerance: {tol})")
    return err


def sum_tolerance(plain, args, kw):
    """The bound on a combined row's sum in float32 whatever the order of
    its additions, ``2 count 2^-24 sum|s|`` over the input rows ``s`` it
    combines (|s| summed by the plain version on the inputs' absolute
    sums), or None where every input sum is integer-valued (the script's
    integer payloads: then any order is exact and the planes must be
    equal)."""
    import dataclasses

    import torch

    states = [x for x in args if hasattr(x, "sum")]
    if all(bool((s.sum == s.sum.round()).all()) for s in states):
        return None
    absolute = [dataclasses.replace(x, sum=x.sum.abs()) if hasattr(x, "sum") else x for x in args]
    out = plain(*absolute, **kw)
    return 2.0 * out.count[:, None].to(torch.float32) * 2.0 ** -24 * out.sum


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


GMM_BLOCK_ELEMENTS = 1 << 26  # expert weights held in float32 at once by gmm_error


def gmm_error(x, w, capacity: int, got=None) -> tuple[float, float]:
    """The grouped-matmul kernel (or its output ``got``) against the float32
    product: (max |kernel - plain version|, max |kernel - product| in units
    of :func:`gmm_tolerance`).  Compared a block of experts at a time, so
    the float32 copies stay under ``GMM_BLOCK_ELEMENTS`` weights (deepseek-v3's
    expert tensor is 7.5 GB in bfloat16)."""
    from repro_torch.kernels import grouped_matmul

    if got is None:
        got = grouped_matmul.grouped_matmul_cuda(x, w, capacity=capacity)
    if got.numel() == 0:
        return 0.0, 0.0
    e, d, f = w.shape
    step = max(1, GMM_BLOCK_ELEMENTS // (d * f))
    ratio = 0.0
    for lo in range(0, e, step):
        rows = slice(lo * capacity, (lo + step) * capacity)
        want32, tol = gmm_tolerance(x[rows], w[lo:lo + step], capacity)
        ratio = max(ratio, float(((got[rows].float() - want32).abs() / tol).max()))
    plain = grouped_matmul.grouped_matmul_plain(x, w, capacity=capacity)
    return float((got.float() - plain.float()).abs().max()), ratio


# deepseek-v3's serve shapes (E, C, D, F): wg/wi 7168 -> 2048 and wo 2048 ->
# 7168 at decode's C = 8 and prefill's C = 40 (batch 4, prompt 256), bfloat16
DEEPSEEK_GMM_SHAPES = ((256, 8, 7168, 2048), (256, 8, 2048, 7168), (256, 40, 7168, 2048),
                       (256, 40, 2048, 7168))


def check_grouped_matmul(dev) -> None:
    """The four serve shapes at the served model's widths (wg/wi 2048 ->
    768 and wo 768 -> 2048 at decode's C = 8 and prefill's C = 64), and
    deepseek-v3's four in bfloat16 (7.5 GB of weights a call), capacities
    13, 72 and 264 (two N tiles of the tensor cores), D and F that are
    multiples of 8 but not of 64, widths that are no multiple of 8 (the
    CUDA-core variant in bfloat16 too), one expert; bfloat16 and float32;
    padding rows zero; each on the variant its dtype and widths call for and
    within :func:`gmm_tolerance` of the float32 product, ``torch.bmm``
    logged beside the serve shapes."""
    import torch

    from repro_torch.kernels import grouped_matmul
    from repro_torch.models.layers import normal

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # bf16: the variant bfloat16 takes at these widths (float32: the CUDA cores)
    cases = [(dtype, *shape) for dtype in (torch.bfloat16, torch.float32) for shape in (
        (128, 8, 2048, 768, "wgmma"), (128, 8, 768, 2048, "wgmma"),
        (128, 64, 2048, 768, "wgmma"), (128, 64, 768, 2048, "wgmma"),
        (3, 13, 200, 136, "wgmma"), (5, 72, 136, 200, "wgmma"), (2, 264, 200, 136, "wgmma"),
        (16, 72, 200, 130, "simt"), (1, 64, 96, 257, "simt"), (3, 13, 1000, 1000, "wgmma"))]
    cases += [(torch.bfloat16, *shape, "wgmma") for shape in DEEPSEEK_GMM_SHAPES]
    for dtype, e, c, d, f, bf16 in cases:
        x = torch.randn((e * c, d), generator=gen, device=dev).to(dtype)
        x.view(e, c, d)[:, c // 2:] = 0  # capacity padding
        w = normal(gen, (e, d, f), 1.0 / math.sqrt(d), dtype, dev)
        want = bf16 if dtype == torch.bfloat16 else "simt"
        got, launched = grouped_matmul.grouped_matmul_launch(x, w, capacity=c)
        if launched != want:
            raise SystemExit(f"FAIL grouped_matmul {dtype} D={d} F={f}: the {launched} "
                             f"variant, expected {want}")
        err, ratio = gmm_error(x, w, c, got=got)
        if ratio > 1.0:
            raise SystemExit(f"FAIL grouped_matmul {dtype} E={e} C={c} D={d} F={f} "
                             f"({want}): {ratio:.3f} x the tolerance (max |diff| {err})")
        if e >= 128:  # the serve shapes: the library's product against the same tolerance
            ref = torch.bmm(x.view(e, c, d), w).view(e * c, f)
            _, lib = gmm_error(x, w, c, got=ref)
            plain = grouped_matmul.grouped_matmul_plain(x, w, capacity=c)
            log(f"grouped_matmul {dtype} C={c} {d}->{f} ({want}): kernel {ratio:.3f}, "
                f"torch.bmm {lib:.3f} x the tolerance; max |kernel - plain| {err}; "
                f"outputs equal to the plain version's: kernel "
                f"{float((got == plain).float().mean()):.4f}, torch.bmm "
                f"{float((ref == plain).float().mean()):.4f}")


BACKWARD_TIMES: list[dict] = []  # check_grouped_matmul_backward's records
# the training path's grouped matmuls (E, C, D, F): qwen3's wg/wi 2048 -> 768
# and wo 768 -> 2048 at C = 128 (4 x 512 tokens, top 8 of 128 experts)
TRAIN_GMM_SHAPES = ((128, 128, 2048, 768), (128, 128, 768, 2048))


def gmm_backward_products(x, w, dy, c: int):
    """The backward's two products as the Function launches them: dX = dY
    @ w^T at capacity C, dW = x^T @ dY at capacity D, as ``(x', w',
    capacity)``."""
    e, d, f = w.shape
    return ((dy, w.transpose(1, 2).contiguous(), c),
            (x.view(e, c, d).transpose(1, 2).contiguous().view(e * d, c), dy.view(e, c, f), d))


def check_grouped_matmul_backward(dev) -> None:
    """Phase 2, the backward (18e): ``GroupedMatmul`` at the training path's
    shapes in bfloat16 and float32: dX and dW within :func:`gmm_tolerance`
    of the float32 products and beside the plain version's autograd
    gradients, on the variant the dtype calls for (bfloat16: the tensor
    cores in all three products); the backward timed beside the plain
    version's and ``torch.bmm``'s autograd backward, with each product's
    bound."""
    import torch

    from repro_torch.kernels import grouped_matmul, ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for dtype in (torch.bfloat16, torch.float32):
        for e, c, d, f in TRAIN_GMM_SHAPES:
            x = torch.randn((e * c, d), generator=gen, device=dev).to(dtype)
            x.view(e, c, d)[:, c - c // 8:] = 0  # capacity padding
            w = (torch.randn((e, d, f), generator=gen, device=dev) / math.sqrt(d)).to(dtype)
            dy = torch.randn((e * c, f), generator=gen, device=dev).to(dtype)
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            ops.reset_launch_counts()
            y = ops.moe_grouped_matmul(xg, wg, capacity=c)
            dx, dw = torch.autograd.grad(y, (xg, wg), dy, retain_graph=True)  # timed below
            launches = dict(ops.LAUNCHES)
            want = ({"grouped_matmul": 3, "grouped_matmul_simt": 0} if dtype == torch.bfloat16
                    else {"grouped_matmul": 0, "grouped_matmul_simt": 3})
            want["grouped_matmul_bwd"] = 2
            if any(launches[k] != v for k, v in want.items()):
                raise SystemExit(f"FAIL grouped_matmul backward {dtype} {d}->{f}: launches "
                                 f"{launches}, expected {want}")
            (px, pw, pc), (qx, qw, qc) = gmm_backward_products(x, w, dy, c)
            err_dx, ratio_dx = gmm_error(px, pw, pc, got=dx)
            err_dw, ratio_dw = gmm_error(qx, qw, qc, got=dw.view(e * d, f))
            if max(ratio_dx, ratio_dw) > 1.0:
                raise SystemExit(f"FAIL grouped_matmul backward {dtype} {d}->{f}: dX "
                                 f"{ratio_dx:.3f}, dW {ratio_dw:.3f} x the tolerance")
            xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
            yp = grouped_matmul.grouped_matmul_plain(xp, wp, capacity=c)
            pdx, pdw = torch.autograd.grad(yp, (xp, wp), dy, retain_graph=True)
            xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
            yb = torch.bmm(xb.view(e, c, d), wb).view(e * c, f)

            def backward_ms(out, ins):
                return cuda_ms(lambda: torch.autograd.grad(out, ins, dy, retain_graph=True),
                               10)[0]

            b_dx, b_dw = _bound("grouped_matmul", (px, pw)), _bound("grouped_matmul", (qx, qw))
            info = dict(
                dtype=str(dtype), E=e, C=c, D=d, F=f, launches=launches,
                dx_share_of_tolerance=ratio_dx, dw_share_of_tolerance=ratio_dw,
                max_abs_diff_plain_dx=float((dx.float() - pdx.float()).abs().max()),
                max_abs_diff_plain_dw=float((dw.float() - pdw.float()).abs().max()),
                backward_ms=backward_ms(y, (xg, wg)), plain_backward_ms=backward_ms(yp, (xp, wp)),
                bmm_backward_ms=backward_ms(yb, (xb, wb)),
                dx_ms=cuda_ms(lambda: grouped_matmul.grouped_matmul_launch(px, pw, capacity=pc),
                              10)[0],
                dw_ms=cuda_ms(lambda: grouped_matmul.grouped_matmul_launch(qx, qw, capacity=qc),
                              10)[0],
                dx_bound_ms=b_dx[0], dx_bound_by=b_dx[1], dw_bound_ms=b_dw[0],
                dw_bound_by=b_dw[1],
                dw_variant=grouped_matmul.variant(dtype, c, f, d)[0])
            BACKWARD_TIMES.append(info)
            log(f"grouped_matmul backward ok: {json.dumps(info)}")
            del x, w, dy, xg, wg, y, dx, dw, xp, wp, yp, pdx, pdw, xb, wb, yb
    torch.cuda.empty_cache()


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
                           # the expert weights do not change while a model
                           # serves: a reference, not a copy (deepseek-v3's
                           # are 7.5 GB a tensor), detached (a trained
                           # model's require gradients)
                           lambda x, w, capacity: ((x.detach().clone(), w.detach()),
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
    return state_diff(name, got, want, sum_tolerance(getattr(mod, plain), args, kw))


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
    # phase 13 joins the same relations on the mesh and must equal these
    JOIN_DATA.update(okey=okey[perm], price=price[perm], w_keys=okey[perm][in_q],
                     c_keys=lines["orderkey"][late], inner=rel, semi=got_semi, anti=got_anti)
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
    """Record the expert ids every MoE router call chose (host copies; the
    expert-parallel dispatch routes through ``moe._route`` too)."""
    from repro_torch.models import moe

    seen, orig = [], moe._route

    def tap(*args, **kw):
        out = orig(*args, **kw)
        seen.append(out[0].cpu())
        return out

    moe._route = tap
    try:
        yield seen
    finally:
        moe._route = orig


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
    from repro_torch.launch.serve import cache_len, generate

    kw = dict(gen=SERVE["gen"], max_len=cache_len(cfg, SERVE["prompt_len"] + SERVE["gen"]),
              keep_logits=True)
    ops.reset_launch_counts()
    with capture(capture_as), routes() as ra:
        a = generate(model, cfg, prompts, backend="cuda", **kw)
    launches = dict(ops.LAUNCHES)
    with routes() as rb:
        b = generate(model, cfg, prompts, backend="torch", force=a.tokens[:, :-1], **kw)
    return a, b, launches, ra, rb


def hold_gate(name: str, a, p, ra, rb) -> float:
    """A float32 gate of :func:`serve_pair`: the kernels and the plain
    versions routed every token to the same experts, their logits agree
    within rtol/atol 1e-3 and their greedy tokens are equal.  Returns the
    largest logit difference."""
    import torch

    if len(ra) != len(rb) or not all(torch.equal(x, y) for x, y in zip(ra, rb)):
        raise SystemExit(f"FAIL {name}: the kernels and the plain versions routed tokens to "
                         "different experts")
    diff = float(np.abs(a.logits - p.logits).max())
    if not np.allclose(a.logits, p.logits, rtol=1e-3, atol=1e-3):
        raise SystemExit(f"FAIL {name}: logits differ by {diff} (rtol/atol 1e-3)")
    check_equal(f"{name} greedy tokens", a.tokens, p.tokens)
    return diff


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

    # device rows only: the runtime's API calls (cudaLaunchKernel, ...) are host rows.
    # The raw events are summed here: key_averages() took ~70 s on one SF-10 aggregate.
    acc: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            us, count = acc.get(e.name(), (0.0, 0))
            acc[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    rows = sorted(((us, name, count) for name, (us, count) in acc.items()), reverse=True)
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
    fp32 = dict(layers=2, max_abs_logit_diff=hold_gate("serve fp32", a, p, ra, rb),
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
    info = dict(
        arch=cfg.name, layers=layers, dtype=cfg.dtype, batch=b, prompt_len=s, gen=gen,
        weight_bytes=weights, param_count=cfg.param_count(), init_s=init_s,
        prefill_s=a.t_prefill, decode_ms_per_token=a.t_decode * 1e3,
        decode_tokens_per_s=b / a.t_decode,
        generated_tokens_per_s=b * gen / (a.t_prefill + (gen - 1) * a.t_decode),
        plain_prefill_s=p.t_prefill, plain_decode_ms_per_token=p.t_decode * 1e3,
        max_memory_allocated=peak, launches=launches,
        max_abs_logit_diff=float(np.abs(a.logits - p.logits).max()),
        equal_top1_share=same_top1, equal_route_share=same_routes, fp32_gate=fp32,
        profile=profile_serve(model, cfg, prompts))
    PROFILES["serve"] = info["profile"]
    log(f"serve: {json.dumps(info)}")
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


def run_path(path: str, kernels, fn, n: int, by_path: dict):
    """Run ``fn`` once with the kernels' launch counts, the host syncs and
    the peak device memory from zero, its kernel inputs captured; fail if
    one of ``kernels`` never launched.  Returns ``(fn's result, info)``."""
    import torch

    from repro_torch.core.types import SYNCS
    from repro_torch.kernels import ops

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
                     max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches)


PHASE5_ONLY = ("hash",)  # held to the CPU path at 2^20 rows only (cut for time)


def baselines_path(dev, rows, q18, rng, by_path: dict, main: dict) -> dict:
    """Phase 10: every baseline on SF-10 Q18 (phase 3's rows and cfg) and
    ``intersect_distinct`` of its order keys against ``orders``', each held
    to the NumPy oracle, with its kernels' launches, wall, rows/s, host
    syncs, peak device memory and ``SpillStats``."""
    import repro_torch
    from repro_torch.core import operators
    from repro_torch.core.types import keys_to_numpy

    cfg = repro_torch.ExecConfig(**MAIN_CFG)
    keys, qty = rows["orderkey"], rows["quantity"]
    n = keys.size
    summary = {}

    def run(path, kernels, fn):
        return run_path(path, kernels, fn, n, by_path)

    for name, (kernels, fn) in baselines().items():
        if name in PHASE5_ONLY:
            continue
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


# ---------------------------------------------------------------------------
# phase 11: the streamed path at SF 10
# ---------------------------------------------------------------------------

STREAM_BATCH_ROWS = 1 << 22  # rows of a column batch: 64 of phase 3's batches
# tests/test_adaptive.py's crossover constants (traditional below a window
# duplicate rate of 0.3125, early_agg above), for a governor made to switch
CROSSOVER = {
    "schema_version": 1,
    "absorb_row_ns": {"traditional": 100.0, "inrun_dedup": 120.0, "early_agg": 150.0,
                      "rs": 900.0},
    "absorb_dup_row_ns": {"traditional": 100.0, "inrun_dedup": 120.0, "early_agg": 50.0,
                          "rs": 900.0},
    "sort_row_ns": 30.0, "merge_row_ns": 50.0, "hash_probe_row_ns": 80.0,
    "spill_write_row_ns": 10.0, "meta": {"backend": "test", "generated_by": "chip_smoke"},
}


@contextlib.contextmanager
def record_streams(seen: list):
    """Note every ``StreamingAggregator`` that absorbs a chunk while the
    block runs (the front door keeps its own), for its arms and events."""
    from repro_torch.core import pipeline

    orig = pipeline.StreamingAggregator.absorb_staged

    def tap(self, staged):
        if not any(a is self for a in seen):
            seen.append(self)
        return orig(self, staged)

    pipeline.StreamingAggregator.absorb_staged = tap
    try:
        yield
    finally:
        pipeline.StreamingAggregator.absorb_staged = orig


def arms_of(agg) -> list[str]:
    """The arms a stream ran, in order."""
    return [agg._governor.events[0]["arm"]] + [e["to"] for e in agg.policy_events]


def kernels_of(arms) -> tuple:
    """The aggregate kernels a stream of these arms must launch:
    ``traditional`` sorts without combining (its merges combine)."""
    return AGG_KERNELS if set(arms) - {"traditional"} else ("argsort", "merge_absorb")


def check_stats(name: str, got: dict, want: dict) -> None:
    if got != want:
        raise SystemExit(f"FAIL {name}: SpillStats differ\n{got}\n{want}")


def stream_sf10(dev, rows, q18, main: dict, by_path: dict) -> dict:
    """Phase 11 a and b: phase 3's SF-10 rows as column batches of 2^22
    rows through ``repro_torch.aggregate``, with ``algorithm="insort"``
    (equal to phase 3's one-shot rows, which equal the oracle exactly, and
    to its ``SpillStats``), then ``"auto"`` (adaptive; equal to the
    oracle)."""
    import repro_torch
    from repro_torch.data.pipeline import iter_column_batches

    cfg = repro_torch.ExecConfig(**MAIN_CFG)
    n = rows["orderkey"].size
    cols = {"orderkey": rows["orderkey"], "quantity": rows["quantity"]}
    out = {}
    for part, alg in (("a", "insort"), ("b", "auto")):
        path = f"stream {alg}"
        seen: list = []

        def go(alg=alg):
            return repro_torch.aggregate(
                iter_column_batches(cols, STREAM_BATCH_ROWS), by=repro_torch.KeySpec.of(
                    orderkey=26), values="quantity", aggs=("count", "sum"), algorithm=alg,
                cfg=cfg, device=dev)

        with record_streams(seen):
            res, info = run_path(path, (), go, n, by_path)
        require_on_card(path, res)
        agg = seen[0]
        arms = arms_of(agg) if agg._governor is not None else [agg.policy]
        require_launches(path, info["launches"], kernels_of(arms))
        check_q18(path, res.state, q18, hash_order=False)
        stats = res.stats.as_dict()
        if alg == "insort":  # phase 3's rows equal q18 exactly (its gate)
            check_stats(f"{path} against phase 3", stats, main["stats"])
        else:
            info.update(arms=arms, policy_events=agg.policy_events,
                        governor_events=agg._governor.events[:8],
                        readbacks_paid=res.stats.readbacks_paid,
                        duplicate_rate=res.stats.duplicate_rate)
        info.update(part=part, rows=n, batch_rows=STREAM_BATCH_ROWS, plan_algorithm=res.plan[
            "algorithm"], state_capacity=res.state.capacity, stats=stats)
        del res
        log(f"phase 11{part}, {path} ok: {json.dumps(info)}")
        settle(path)
        out[path] = info
    return out


def phase_change_chunks(rng, M: int, chunks_per_phase: int = 32):
    """``benchmarks/bench_adaptive.py``'s streams: a unique-heavy phase (keys
    over 2^31) and a duplicate-heavy one (keys in [1, M/64)), chunks of M
    rows.  The values are integer-valued (1..50), so every sum is exact."""
    n = chunks_per_phase * M

    def chunked(keys):
        vals = rng.integers(1, 51, (n, 1)).astype(np.float32)
        return [(keys[i:i + M], vals[i:i + M]) for i in range(0, n, M)]

    return {"uniq": chunked(rng.integers(1, 2**31, size=n).astype(np.uint32)),
            "dup": chunked(rng.integers(1, max(2, M // 64), size=n).astype(np.uint32))}


def check_oracle(name: str, state, want) -> None:
    keys, cnt, sums = state_relation(state)
    uk, ucnt, usums = want
    check_equal(f"{name} keys", keys, uk)
    check_equal(f"{name} counts", cnt, ucnt)
    check_equal(f"{name} sums", sums, usums)


def feed(agg, chunks) -> None:
    """The double-buffered protocol: stage chunk k+1, then absorb chunk k."""
    staged = None
    for keys, vals in chunks:
        nxt = agg.stage(keys, vals)
        agg.absorb_staged(staged)
        staged = nxt
    agg.absorb_staged(staged)


def stream_phase_change(dev, by_path: dict) -> dict:
    """Phase 11 c: both orders of the phase-change stream (33,554,432 rows)
    through adaptive and each fixed arm at phase 3's ``ExecConfig``, the
    staged double-buffered loop; each equal to the oracle, with each
    phase's wall and the switches."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.core.types import ExecConfig, SYNCS
    from repro_torch.kernels import ops

    cfg = ExecConfig(**MAIN_CFG)
    phases = phase_change_chunks(np.random.default_rng(3), cfg.memory_rows, 16)
    keys = np.concatenate([k for p in phases.values() for k, _ in p])
    vals = np.concatenate([v for p in phases.values() for _, v in p])
    want = oracle(keys, vals[:, 0])
    n = keys.size
    del keys, vals
    path = "stream phase-change"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = {}
    with capture(path):
        for order in ("uniq->dup", "dup->uniq"):
            for policy in ("adaptive",) + pipeline.ADAPTIVE_ARMS:
                SYNCS["host_syncs"] = 0
                agg = pipeline.StreamingAggregator(cfg, policy=policy, width=1, device=dev)
                walls = []
                for name in order.split("->"):
                    _, wall = timed(lambda name=name: feed(agg, phases[name]))
                    walls.append(wall)
                (state, stats), fin = timed(agg.finalize)
                check_oracle(f"{path} {order} {policy}", state, want)
                del state
                info = dict(phase_walls_s=walls, finalize_s=fin, rows=n,
                            rows_per_s=n / (sum(walls) + fin), host_syncs=SYNCS["host_syncs"],
                            spill_rows=stats.total_spill_rows, runs=stats.runs_generated)
                if policy == "adaptive":
                    info.update(arms=arms_of(agg), policy_events=agg.policy_events,
                                readbacks_paid=stats.readbacks_paid,
                                duplicate_rate=stats.duplicate_rate)
                out[f"{order} {policy}"] = info
                log(f"phase 11c, {order} {policy} ok: {json.dumps(info)}")
    launches = dict(ops.LAUNCHES)
    by_path[path] = launches
    require_launches(path, launches, AGG_KERNELS)
    settle(path)
    return out


def spill_parity_stream(dev, by_path: dict) -> dict:
    """Phase 11 d: a uniq->dup stream of 2^20 rows at the spill-parity
    ``ExecConfig``, adaptive with a governor made to switch (start
    ``traditional``, the crossover constants), through the card and the
    plain CPU path: equal states, ``SpillStats`` (the observation block
    included) and policy events, at least one switch.  On the card a
    snapshot at the middle chunk leaves every engine tensor byte-identical;
    both devices evict the keys below 2^30 at three quarters and must
    retire the same rows."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.core.adaptive import GovernorConfig, PolicyGovernor
    from repro_torch.core.types import ExecConfig, state_to_numpy
    from repro_torch.kernels import ops

    cfg = ExecConfig(**SPILL_CFG)
    phases = phase_change_chunks(np.random.default_rng(4), cfg.memory_rows)
    chunks = phases["uniq"] + phases["dup"]
    n = sum(k.size for k, _ in chunks)
    path = "stream spill parity"
    got = {}
    for d in (dev, "cpu"):
        gov = PolicyGovernor(cfg, config=GovernorConfig(
            constants=CROSSOVER, start="traditional", hysteresis=0.05, min_window_rows=64))
        agg = pipeline.StreamingAggregator(cfg, policy="adaptive", width=1, governor=gov,
                                           device=d)
        if d == dev:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        retired = None
        with capture(path) if d == dev else contextlib.nullcontext():
            for i, (k, v) in enumerate(chunks):
                agg.absorb(k, v)
                if i == len(chunks) // 2 and d == dev:
                    snapshot_unchanged(agg, chunks[:i + 1])
                if i == 3 * len(chunks) // 4:
                    retired = agg.evict_below(1 << 30)
            state, stats = agg.finalize()
        got[str(d)] = (state_to_numpy(state), stats.as_dict(), agg.policy_events, retired,
                       time.perf_counter() - t0)
        if d == dev:
            launches = dict(ops.LAUNCHES)
            by_path[path] = launches
            require_launches(path, launches, AGG_KERNELS)
    (sa, da, ea, ra, ta), (sb, db, eb, rb, tb) = got[str(dev)], got["cpu"]
    for f in sa:
        check_equal(f"{path} {f}", sa[f], sb[f])
    check_stats(path, da, db)
    if ea != eb or ra != rb:
        raise SystemExit(f"FAIL {path}: policy events or retired rows differ\n{ea} {ra}\n{eb} {rb}")
    if da["policy_switches"] < 1 or da["rows_retired"] != ra or ra <= 0:
        raise SystemExit(f"FAIL {path}: no switch or no eviction: {da}")
    info = dict(rows=n, stats=da, policy_events=ea, retired=ra, card_s=ta, cpu_s=tb)
    log(f"phase 11d, {path} ok: {json.dumps(info)}")
    settle(path)
    return info


def unchanged(name: str, es, fn):
    """Run ``fn`` (a snapshot); fail unless every tensor of the engine
    ``es`` is byte-identical after it and its host counters are equal.
    Returns ``(fn's result, the number of tensors)``."""
    import torch

    tensors = [getattr(s, f) for s in (es.table, es.table2, es.store)
               for f in ("keys", "count", "sum", "min", "max")] + [es.frontier]
    before = [t.clone() for t in tensors]

    def host():
        return (list(es.lens), es.cursor, es.ridx, es.spilled, es.absorbed, es.dups,
                es.resident, es.resident2)

    counters = host()
    out = fn()
    same = [torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
            for a, b in zip(before, tensors)]
    if not all(same) or counters != host():
        raise SystemExit(f"FAIL {name}: the engine changed")
    return out, len(tensors)


def snapshot_unchanged(agg, absorbed) -> None:
    """A snapshot of the live engine: every engine tensor byte-identical
    before and after, and the snapshot equal to the oracle of what was
    absorbed."""
    (state, _), n_tensors = unchanged("stream snapshot", agg._es, agg.snapshot)
    keys = np.concatenate([k for k, _ in absorbed])
    vals = np.concatenate([v for _, v in absorbed])
    check_oracle("stream snapshot", state, oracle(keys, vals[:, 0]))
    log(f"phase 11d: the snapshot after {keys.size} rows left {n_tensors} engine tensors "
        "byte-identical")


def stream_path(dev, rows, q18, main: dict, by_path: dict) -> dict:
    """Phase 11: the streamed path (parts a–d)."""
    out = stream_sf10(dev, rows, q18, main, by_path)
    out["phase change"] = stream_phase_change(dev, by_path)
    out["spill parity"] = spill_parity_stream(dev, by_path)
    return out


# ---------------------------------------------------------------------------
# phase 12: aggregation as a service
# ---------------------------------------------------------------------------

SERVICE_SNAPSHOTS_AT = (5, 10)  # part a: snapshots after these column batches; evict at the last
SERVICE_DRIFT = dict(chunks=64, chunk_rows=1 << 20, every=8, ttl=2)  # part b


def bincount_oracle(keys: np.ndarray, vals: np.ndarray):
    """Group keys, counts, float64 sums and sums of |value| of small
    non-negative integer keys, by ``np.bincount`` (the keys index the bins)."""
    cnt = np.bincount(keys)
    uk = np.flatnonzero(cnt)
    v = vals.astype(np.float64)
    return (uk.astype(keys.dtype), cnt[uk], np.bincount(keys, weights=v)[uk],
            np.bincount(keys, weights=np.abs(v))[uk])


def check_relation(name: str, keys, counts, sums, want, *, exact: bool) -> float:
    """Keys and counts equal to the oracle; sums exactly, or within float32's
    bound for adding a group's values in another order (2 n 2^-24 Σ|x|).
    Returns the largest |sum difference|."""
    uk, ucnt, usums, uabs = want
    check_equal(f"{name} keys", keys, uk)
    check_equal(f"{name} counts", counts, ucnt)
    sums = np.asarray(sums, np.float64)
    if exact:
        check_equal(f"{name} sums", sums, usums)
        return 0.0
    err = np.abs(sums - usums)
    tol = 2.0 * ucnt * 2.0 ** -24 * uabs + 1e-30
    if not bool(np.all(err <= tol)):
        raise SystemExit(f"FAIL {name} sums: {int(np.sum(err > tol))} groups past 2 n 2^-24 "
                         "sum|x|")
    return float(err.max()) if err.size else 0.0


def resident_below(es, threshold: int) -> int:
    """The engine's resident rows with key below ``threshold``, counted in
    NumPy on host copies of the run store and the tables (their rows past
    the valid ones are EMPTY, above every threshold)."""
    n = int(np.count_nonzero(es.store.keys.cpu().numpy() < threshold))
    for t in (es.table, es.table2):
        n += int(np.count_nonzero(t.keys.cpu().numpy() < threshold))
    return n


def service_sf10(dev, rows, by_path: dict) -> dict:
    """Phase 12 a: SF-10 Q18 as a service.  Phase 11a's 15 column batches of
    2^22 rows through ``repro_torch.serve_aggregate`` (``rs``); snapshots
    after batches 5 and 10, each equal to the oracle of its prefix and
    leaving every engine tensor byte-identical; after batch 10
    ``expire_below`` retires the orders below the prefix's 25th-percentile
    order key (``rows_retired`` equal to a NumPy count of the engine's rows
    below it); the close equals the oracle of every row at or above the
    cutoff plus the rows that arrived after the eviction."""
    import torch

    import repro_torch
    from repro_torch.core.types import SYNCS
    from repro_torch.data.pipeline import iter_column_batches
    from repro_torch.kernels import ops

    cfg = repro_torch.ExecConfig(**MAIN_CFG)
    keys, qty = rows["orderkey"], rows["quantity"]
    n, B = keys.size, STREAM_BATCH_ROWS
    path = "service sf10"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    SYNCS["host_syncs"] = 0
    sess = repro_torch.serve_aggregate(
        by=repro_torch.KeySpec.of(orderkey=26), values="quantity", aggs=("count", "sum"),
        watermark="orderkey", cfg=cfg, policy="rs", device=dev)
    walls, snaps, cutoff, retired = {"ingest": 0.0}, [], None, None
    with capture(path):
        for i, batch in enumerate(iter_column_batches({"orderkey": keys, "quantity": qty}, B)):
            t0 = time.perf_counter()
            sess.ingest(batch)
            if i + 1 in SERVICE_SNAPSHOTS_AT:  # the queried state: every batch absorbed
                sess._svc.flush()
                sess._svc.wait()
            walls["ingest"] += time.perf_counter() - t0
            if i + 1 not in SERVICE_SNAPSHOTS_AT:
                continue
            svc = sess._svc
            syncs = SYNCS["host_syncs"]
            (res, n_tensors), wall = timed(
                lambda: unchanged(f"{path} snapshot", svc._agg._es, sess.snapshot))
            snap_syncs = SYNCS["host_syncs"] - syncs
            rel = res.relation()
            m = (i + 1) * B
            check_relation(f"{path} snapshot after {i + 1} batches", rel["orderkey"],
                           rel["count"], rel["sum"][:, 0], bincount_oracle(keys[:m], qty[:m]),
                           exact=True)
            snaps.append(dict(batches=i + 1, rows=m, wall_s=wall, host_syncs=snap_syncs,
                              engine_tensors_unchanged=n_tensors,
                              max_memory_allocated=torch.cuda.max_memory_allocated(),
                              stats=res.stats.as_dict()))
            del res, rel
            if i + 1 == SERVICE_SNAPSHOTS_AT[-1]:
                cutoff = int(np.partition(keys[:m], m // 4)[m // 4])
                want = resident_below(svc._agg._es, cutoff)
                retired, walls["expire"] = timed(lambda: sess.expire_below(orderkey=cutoff))
                if retired != want or retired <= 0:
                    raise SystemExit(f"FAIL {path}: rows_retired {retired}, NumPy's count "
                                     f"{want}")
        final, walls["close"] = timed(sess.close)
    launches = dict(ops.LAUNCHES)
    by_path[path] = launches
    require_launches(path, launches, AGG_KERNELS)
    require_on_card(path, final)
    m = SERVICE_SNAPSHOTS_AT[-1] * B
    live = np.ones(n, bool)
    live[:m] = keys[:m] >= cutoff
    rel = final.relation()
    check_relation(f"{path} close", rel["orderkey"], rel["count"], rel["sum"][:, 0],
                   bincount_oracle(keys[live], qty[live]), exact=True)
    if final.stats.rows_retired != retired:
        raise SystemExit(f"FAIL {path}: the close reports {final.stats.rows_retired} rows "
                         f"retired, the eviction {retired}")
    info = dict(rows=n, batch_rows=B, walls_s=walls, ingest_rows_per_s=n / walls["ingest"],
                host_syncs=SYNCS["host_syncs"], snapshots=snaps, cutoff=cutoff,
                rows_retired=retired, max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches=launches, plan_calibrated_backend=final.plan["cost_model"][
                    "calibrated_backend"], metrics=sess.metrics.summary(),
                stats=final.stats.as_dict())
    del final, rel
    log(f"phase 12a, {path} ok: {json.dumps(info)}")
    settle(path)
    return info


def service_drift(dev, by_path: dict) -> dict:
    """Phase 12 b: ``launch/serve_agg.py``'s drifting traffic at card scale
    through ``AggregationService`` at phase 3's ``ExecConfig``: 64 chunks of
    2^20 rows (key space 2^20, drift 0.02 a chunk), a snapshot every 8
    chunks after the TTL-2 eviction ``serve()`` applies, once with ``rs``
    and once with ``adaptive`` under the committed constants, which must be
    the card's.  The close equals the oracle of the rows not retired."""
    import torch

    from repro_torch.core import schema
    from repro_torch.core.types import SYNCS, ExecConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_agg
    from repro_torch.service import AggregationService

    cfg = ExecConfig(**MAIN_CFG)
    c = SERVICE_DRIFT
    keyspace, n = c["chunk_rows"], c["chunks"] * c["chunk_rows"]
    chunks = list(serve_agg.synth_chunks(c["chunks"], c["chunk_rows"], keyspace=keyspace,
                                         seed=SEED))
    plan = schema._plan(n, cfg, n, device_type=dev.type)
    out = {}
    for policy in ("rs", "adaptive"):
        path = f"service drift {policy}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        SYNCS["host_syncs"] = 0
        svc = AggregationService(cfg, policy=policy, width=1,
                                 output_rows=1 << (n - 1).bit_length(), output_estimate=n,
                                 device=dev)
        t_ingest, ingest_syncs, snap_syncs, evictions = 0.0, 0, [], []
        with capture(path):
            for i, (k, p) in enumerate(chunks):
                boundary = (i + 1) % c["every"] == 0 or i + 1 == len(chunks)
                s0, t0 = SYNCS["host_syncs"], time.perf_counter()
                svc.ingest(k, p)
                if boundary:  # the held chunk is absorbed before the query
                    svc.flush()
                    svc.wait()
                t_ingest += time.perf_counter() - t0
                ingest_syncs += SYNCS["host_syncs"] - s0
                if (i + 1) % c["every"]:
                    continue
                cut = serve_agg.ttl_cutoff(i + 1, ttl=c["ttl"], snapshot_every=c["every"],
                                           keyspace=keyspace)
                if cut > 0:
                    svc.retire_below(cut)
                    evictions.append((i + 1, cut))
                s0 = SYNCS["host_syncs"]
                svc.snapshot()
                snap_syncs.append(SYNCS["host_syncs"] - s0)
            (state, stats), close_s = timed(svc.close)
        launches = dict(ops.LAUNCHES)
        by_path[path] = launches
        agg = svc._agg
        arms = arms_of(agg) if agg._governor is not None else [policy]
        require_launches(path, launches, kernels_of(arms))
        # a chunk's rows are retired by the newest eviction after it
        thr = np.zeros(c["chunks"], np.int64)
        for done, cut in evictions:
            thr[:done] = np.maximum(thr[:done], cut)
        keys = np.concatenate([k for k, _ in chunks])
        vals = np.concatenate([v[:, 0] for _, v in chunks])
        live = keys >= np.repeat(thr, c["chunk_rows"])
        got = state_relation(state)
        err = check_relation(f"{path} close", *got, bincount_oracle(keys[live], vals[live]),
                             exact=False)
        del keys, vals, live, got, state
        m = svc.metrics
        info = dict(
            rows=n, ingest_s=t_ingest, ingest_rows_per_s=n / t_ingest, close_s=close_s,
            snapshot_p50_s=m.snapshot_latency_s(0.5), snapshot_p99_s=m.snapshot_latency_s(0.99),
            snapshot_latencies_s=m.snapshot_latencies_s, host_syncs_ingest=ingest_syncs,
            host_syncs_snapshots=snap_syncs, evictions=evictions,
            rows_retired=stats.rows_retired, max_sum_diff=err, arms=arms,
            policy_switches=stats.policy_switches, readbacks_paid=stats.readbacks_paid,
            plan_calibrated_backend=plan["cost_model"]["calibrated_backend"],
            max_memory_allocated=torch.cuda.max_memory_allocated(), launches=launches,
            metrics=m.summary(), stats=stats.as_dict())
        if agg._governor is not None:
            info["governor_constants"] = agg._governor._constants["meta"].get("backend")
        if "cuda" not in (info["plan_calibrated_backend"], info.get("governor_constants", "cuda")):
            raise SystemExit(f"FAIL {path}: planned under another device's constants: {info}")
        log(f"phase 12b, {path} ok: {json.dumps(info)}")
        settle(path)
        out[path] = info
    return out


def service_launcher() -> dict:
    """Phase 12 c: ``python -m repro_torch.launch.serve_agg --smoke`` on the
    card, in its own process."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_agg", "--smoke"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not any(x.startswith("ingested 6144 rows") and " on cuda" in x
                                    for x in lines):
        raise SystemExit(f"FAIL serve_agg --smoke: rc {r.returncode}\n{r.stdout}\n{r.stderr}")
    info = dict(wall_s=wall, report=lines[-3:])
    log(f"phase 12c, serve_agg --smoke ok: {json.dumps(info)}")
    return info


def service_path(dev, rows, by_path: dict) -> dict:
    """Phase 12: aggregation as a service (parts a–c); the aggregate kernels
    must each have launched on it."""
    out = {"sf10": service_sf10(dev, rows, by_path)}
    out.update(service_drift(dev, by_path))
    out["launcher"] = service_launcher()
    total = {k: sum(v[k] for p, v in by_path.items() if p.startswith("service"))
             for k in AGG_KERNELS}
    require_launches("service", total, AGG_KERNELS)
    log(f"phase 12 launches: {json.dumps(total)}")
    return out


# ---------------------------------------------------------------------------
# phase 13: distributed aggregation on a mesh of ranks (one process each)
# ---------------------------------------------------------------------------

MESH_WORLD = 4
MESH_DRIFT = dict(chunks=16, chunk_rows=1 << 20, every=4, ttl=2)  # part c
MESH_SHARD_AGG = ("--rows", str(1 << 23), "--zipf", "1.2", "--memory-rows",
                  str(MAIN_CFG["memory_rows"]), "--batch-rows", str(MAIN_CFG["batch_rows"]))
EXCHANGE_FIELDS = ("rows_exchanged", "exchange_quota", "exchange_max_fill", "exchange_retries")
JOIN_DATA: dict = {}  # phase 6's orders and its one-device joins, for part b


def _mesh_part(report: dict, path: str, rank: int, mesh, kernels, fn):
    """Run one part of phase 13 on this rank: launches counted from zero,
    rank 0's kernel inputs captured, wall, host syncs and peak memory.  A
    rank whose part never launched one of ``kernels`` fails."""
    import torch

    from repro_torch.core.types import SYNCS
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops

    sharding.barrier(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    SYNCS["host_syncs"] = 0
    collectives = dict(sharding.COLLECTIVES)
    t0 = time.perf_counter()
    with capture(path) if rank == 0 else contextlib.nullcontext():
        out, info = fn()
        torch.cuda.synchronize()
    info = dict(wall_s=time.perf_counter() - t0, host_syncs=SYNCS["host_syncs"],
                collectives={k: v - collectives[k] for k, v in sharding.COLLECTIVES.items()},
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                launches=dict(ops.LAUNCHES), **info)
    require_launches(f"{path} rank {rank}", info["launches"], kernels)
    report[path] = info
    return out


def _shard_rows(state):
    from repro_torch.core.types import keys_to_numpy

    keys = keys_to_numpy(state.keys, state.key_dtype)
    live = keys != np.iinfo(keys.dtype).max
    return (keys[live], state.count.cpu().numpy()[live],
            state.sum[:, 0].cpu().numpy().astype(np.float64)[live])


def mesh_rank(rank: int, world: int, rdv: str, run_dir: str, backend: str, parts: str) -> None:
    """One rank of phase 13 (``torch.multiprocessing`` target): join the
    ranks over ``backend``, run ``parts`` ("abcd") on the mesh, write the
    rank's report and result shards under ``run_dir``.  Any failure
    raises, which fails the parent."""
    import torch

    import repro_torch
    from repro_torch.core import pipeline
    from repro_torch.core.types import ExecConfig, state_to_numpy
    from repro_torch.distributed import groupby as gb
    from repro_torch.distributed import sharding
    from repro_torch.launch import serve_agg
    from repro_torch.service import AggregationService

    sharding.init_distributed(backend=backend, num_processes=world, process_id=rank,
                              init_method=f"file://{rdv}", timeout_s=900)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = sharding.data_mesh("data", device=dev)
    d = Path(run_dir)
    tag = f"{backend}{world}"
    report: dict = {"rank": rank, "world": world, "backend": backend, "device": str(dev)}
    by = repro_torch.KeySpec.of(orderkey=26)
    cfg = ExecConfig(**MAIN_CFG)

    def rows(name):  # this rank's slice of a column the parent wrote
        return sharding.local_slice(np.load(d / f"{name}.npy", mmap_mode="r"), mesh, pad=False)

    def agg(keys, values=None, aggs=("count",)):
        return repro_torch.aggregate({"orderkey": keys}, by=by, values=values, aggs=aggs,
                                     cfg=cfg, mesh=mesh, device=dev)

    # a) SF-10 Q18's inner aggregate, the rank's rows of phase 3's input
    def part_a():
        res = agg(rows("orderkey"), rows("quantity"), ("count", "sum"))
        return res, dict(stats=res.stats.as_dict(), plan_mesh=res.plan["mesh"])

    L = _mesh_part(report, f"mesh aggregate {tag}", rank, mesh, AGG_KERNELS, part_a)
    k, c, s = _shard_rows(L.state)
    np.savez(d / f"a_{tag}_{rank}.npz", keys=k, count=c, sum=s)
    if "b" in parts:
        # b) Q18's merge join and Q4's semi and anti joins, both sides on the mesh
        def part_b():
            O = agg(rows("okey"), rows("price"), ("sum",))
            W, C = agg(rows("w_keys")), agg(rows("c_keys"))
            J = O.merge_join(L, mesh=mesh)
            semi = W.merge_join(C, how="semi", mesh=mesh)
            anti = W.merge_join(C, how="anti", mesh=mesh)
            return (J, semi, anti), dict(stats=J.stats.as_dict(), plan_mesh=J.plan["mesh"],
                                         anti_exchange=anti.plan["mesh"]["exchange"])

        J, semi, anti = _mesh_part(report, "mesh merge_join", rank, mesh,
                                   AGG_KERNELS + ("join_probe",), part_b)
        t0 = time.perf_counter()
        rel, got_semi, got_anti = J.relation(), semi.relation(), anti.relation()
        report["mesh merge_join"]["gather_s"] = time.perf_counter() - t0
        if rank == 0:
            np.savez(d / "b.npz", semi=got_semi["orderkey"], anti=got_anti["orderkey"],
                     **{f"inner_{k}": v for k, v in rel.items()})
        del J, semi, anti, rel
    del L
    if "c" in parts:
        # c) serve_agg's drifting traffic through a mesh stream and a mesh
        # service (every rank stages the same chunks and keeps its slice)
        m = MESH_DRIFT
        chunks = list(serve_agg.synth_chunks(m["chunks"], m["chunk_rows"],
                                             keyspace=m["chunk_rows"], seed=SEED))
        keys = np.concatenate([k for k, _ in chunks])
        vals = np.concatenate([v[:, 0] for _, v in chunks])

        def part_stream():
            st, stats = pipeline.insort_aggregate_device_stream(iter(chunks), cfg, policy="rs",
                                                                mesh=mesh, device=dev)
            return st, dict(stats=stats.as_dict())

        st = _mesh_part(report, "mesh stream", rank, mesh, AGG_KERNELS, part_stream)
        whole = gb.gather_state(st, mesh)
        if rank == 0:
            err = check_relation("mesh stream", *state_relation(whole),
                                 bincount_oracle(keys, vals), exact=False)
            report["mesh stream"]["max_sum_diff"] = err
        del st, whole

        def part_service():
            svc = AggregationService(cfg, policy="rs", width=1, mesh=mesh, device=dev)
            snaps, evictions = [], []
            thr = np.zeros(len(chunks), np.int64)
            for i, (kc, pc) in enumerate(chunks):
                svc.ingest(kc, pc)
                if (i + 1) % m["every"]:
                    continue
                cut = serve_agg.ttl_cutoff(i + 1, ttl=m["ttl"], snapshot_every=m["every"],
                                           keyspace=m["chunk_rows"])
                if cut > 0:
                    svc.retire_below(cut)
                    evictions.append((i + 1, cut))
                    thr[:i + 1] = np.maximum(thr[:i + 1], cut)
                svc.flush()
                (state, stats), n_tensors = unchanged(f"mesh service snapshot {i + 1} rank {rank}",
                                                      svc._agg._es, svc.snapshot)
                whole = gb.gather_state(state, mesh)
                n = (i + 1) * m["chunk_rows"]
                live = keys[:n] >= np.repeat(thr[:i + 1], m["chunk_rows"])
                if rank == 0:
                    check_relation(f"mesh service snapshot after {i + 1} chunks",
                                   *state_relation(whole),
                                   bincount_oracle(keys[:n][live], vals[:n][live]), exact=False)
                snaps.append(dict(chunks=i + 1, engine_tensors_unchanged=n_tensors,
                                  rows_retired=stats.rows_retired,
                                  rows_exchanged=stats.rows_exchanged))
            state, stats = svc.close()
            whole = gb.gather_state(state, mesh)
            live = keys >= np.repeat(thr, m["chunk_rows"])
            if rank == 0:
                check_relation("mesh service close", *state_relation(whole),
                               bincount_oracle(keys[live], vals[live]), exact=False)
            if not evictions or stats.rows_retired <= 0:
                raise SystemExit(f"FAIL mesh service: nothing was retired ({evictions})")
            return None, dict(snapshots=snaps, evictions=evictions, stats=stats.as_dict(),
                              metrics=svc.metrics.summary())

        _mesh_part(report, "mesh service", rank, mesh, AGG_KERNELS, part_service)
    if "d" in parts:
        # d) spill parity: 2^20 SF-10 rows at SPILL_CFG on the card and on CPU
        # ranks over the same gloo group, and the ranks' one-device runs
        n = 1 << 20
        spill_cfg = ExecConfig(**SPILL_CFG)
        keys = sharding.local_slice(np.load(d / "orderkey.npy", mmap_mode="r")[:n], mesh)
        qty = sharding.local_slice(np.load(d / "quantity.npy", mmap_mode="r")[:n], mesh)
        cpu_mesh = sharding.data_mesh("data", device="cpu")

        def part_d():
            st, stats = pipeline.insort_aggregate_device(keys, qty, spill_cfg, output_estimate=n,
                                                         mesh=mesh, device=dev)
            return (st, stats), dict(stats=stats.as_dict())

        st, stats = _mesh_part(report, "mesh spill parity", rank, mesh, AGG_KERNELS, part_d)
        st_cpu, stats_cpu = pipeline.insort_aggregate_device(keys, qty, spill_cfg,
                                                             output_estimate=n, mesh=cpu_mesh,
                                                             device="cpu")
        got, want = state_to_numpy(st), state_to_numpy(st_cpu)
        for f in got:
            check_equal(f"mesh spill parity rank {rank} {f}", got[f], want[f])
        if stats.as_dict() != stats_cpu.as_dict():
            raise SystemExit(f"FAIL mesh spill parity rank {rank}: SpillStats differ\n"
                             f"{stats.as_dict()}\n{stats_cpu.as_dict()}")
        if stats.total_spill_rows == 0 or stats.rows_spilled_merge == 0:
            raise SystemExit(f"FAIL mesh spill parity: the input did not spill: {stats}")
        local = pipeline.insort_aggregate_device(keys, qty, spill_cfg, output_estimate=n,
                                                 device=dev)[1]
        report["mesh spill parity"]["local_stats"] = local.as_dict()
    if rank == 0:  # rank 0's captured inputs against the plain versions
        before = dict(MAX_ERR)
        for path in list(CAPTURED):
            settle(path)
        report["max_err"] = {k: v for k, v in MAX_ERR.items() if v != before.get(k)}
        report["checked_shapes"] = {
            p: {k: [list(key) + [calls] for key, (calls, _) in sigs.items()]
                for k, sigs in kinds.items() if sigs} for p, kinds in CAPTURED.items()}
    (d / f"report_{tag}_{rank}.json").write_text(json.dumps(report))


def _spawn_mesh(run_dir: Path, world: int, backend: str, parts: str) -> list[dict]:
    import torch.multiprocessing as mp

    tag = f"{backend}{world}"
    rdv = run_dir / f"rendezvous_{tag}"
    t0 = time.perf_counter()
    mp.start_processes(mesh_rank, args=(world, str(rdv), str(run_dir), backend, parts),
                       nprocs=world, start_method="spawn")
    log(f"phase 13: {world} {backend} ranks ran parts {parts} in "
        f"{time.perf_counter() - t0:.1f} s")
    return [json.loads((run_dir / f"report_{tag}_{r}.json").read_text()) for r in range(world)]


def _same_on_ranks(name: str, values: list) -> None:
    if any(v != values[0] for v in values[1:]):
        raise SystemExit(f"FAIL {name}: the ranks disagree: {values}")


def check_mesh_aggregate(run_dir: Path, reports: list[dict], q18, n_rows: int) -> dict:
    """Part a: the ranks' shards, EMPTY dropped and concatenated in rank
    order, equal the oracle exactly; rank r's keys all lie below rank
    r+1's; every rank reports the same SpillStats; fewer rows crossed the
    wire than the input holds."""
    world, tag = len(reports), f"{reports[0]['backend']}{len(reports)}"
    path = f"mesh aggregate {tag}"
    shards = [np.load(run_dir / f"a_{tag}_{r}.npz") for r in range(world)]
    for r, sh in enumerate(shards):
        k = sh["keys"]
        if k.size > 1 and not bool(np.all(k[1:] > k[:-1])):
            raise SystemExit(f"FAIL {path}: rank {r}'s keys are not sorted and unique")
        if r and k.size and shards[r - 1]["keys"].size and k[0] <= shards[r - 1]["keys"][-1]:
            raise SystemExit(f"FAIL {path}: rank {r}'s keys do not all lie above rank {r - 1}'s")
    uk, cnt, sums = q18
    check_equal(f"{path} keys", np.concatenate([sh["keys"] for sh in shards]), uk)
    check_equal(f"{path} counts", np.concatenate([sh["count"] for sh in shards]), cnt)
    check_equal(f"{path} sums", np.concatenate([sh["sum"] for sh in shards]), sums)
    stats = [rep[path]["stats"] for rep in reports]
    _same_on_ranks(f"{path} SpillStats", stats)
    if not 0 < stats[0]["rows_exchanged"] < n_rows:
        raise SystemExit(f"FAIL {path}: rows_exchanged {stats[0]['rows_exchanged']}")
    return dict(rows=n_rows, groups=int(uk.size), shard_groups=[int(sh["keys"].size)
                                                                 for sh in shards],
                **{k: stats[0][k] for k in EXCHANGE_FIELDS}, stats=stats[0],
                ranks=[{k: rep[path][k] for k in ("wall_s", "host_syncs", "collectives",
                                                  "max_memory_allocated", "launches")}
                       for rep in reports])


def mesh_path(dev, rows, q18, by_path: dict) -> dict:
    """Phase 13: the mesh paths, one process a rank (parts a–e)."""
    import os

    import torch

    run_dir = ROOT / "build" / "mesh_phase"
    if run_dir.exists():
        for p in run_dir.iterdir():
            p.unlink()
    run_dir.mkdir(parents=True, exist_ok=True)
    n_rows = rows["orderkey"].size
    np.save(run_dir / "orderkey.npy", rows["orderkey"])
    np.save(run_dir / "quantity.npy", rows["quantity"])
    for name in ("okey", "price", "w_keys", "c_keys"):
        np.save(run_dir / f"{name}.npy", JOIN_DATA[name])
    gc.collect()
    torch.cuda.empty_cache()
    out: dict = {}
    reports = _spawn_mesh(run_dir, MESH_WORLD, "gloo", "abcd")
    out["a"] = check_mesh_aggregate(run_dir, reports, q18, n_rows)
    log(f"phase 13a, mesh aggregate ok: {json.dumps(out['a'])}")

    # b) the mesh joins equal phase 6's one-device joins
    b = np.load(run_dir / "b.npz")
    for col, want in JOIN_DATA["inner"].items():
        got = b[f"inner_{col}"]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise SystemExit(f"FAIL mesh merge_join {col}: differs from phase 6's join")
    check_equal("mesh semi join", b["semi"], JOIN_DATA["semi"])
    check_equal("mesh anti join", b["anti"], JOIN_DATA["anti"])
    _same_on_ranks("mesh merge_join stats", [rep["mesh merge_join"]["stats"] for rep in reports])
    out["b"] = dict(inner_rows=int(JOIN_DATA["inner"]["orderkey"].size),
                    anti_rows=int(b["anti"].size), plan_mesh=reports[0]["mesh merge_join"][
                        "plan_mesh"], ranks=[{k: rep["mesh merge_join"][k] for k in (
                            "wall_s", "gather_s", "host_syncs", "collectives",
                            "max_memory_allocated", "launches")} for rep in reports])
    log(f"phase 13b, mesh merge_join ok: {json.dumps(out['b'])}")

    # c) checked inside rank 0 against NumPy; the ranks agree on the stats
    for path in ("mesh stream", "mesh service"):
        _same_on_ranks(f"{path} stats", [rep[path]["stats"] for rep in reports])
        out[path] = dict(reports[0][path], ranks=[{k: rep[path][k] for k in (
            "wall_s", "host_syncs", "collectives", "max_memory_allocated", "launches")}
            for rep in reports])
    log(f"phase 13c, mesh stream and service ok: {json.dumps(out['mesh stream'])} "
        f"{json.dumps(out['mesh service'])}")

    # d) the mesh's stats = the ranks' one-device runs reduced, but for the exchange's
    from repro_torch.core.types import SpillStats

    path = "mesh spill parity"
    stats = [rep[path]["stats"] for rep in reports]
    _same_on_ranks(f"{path} stats", stats)
    local = [SpillStats(**{k: v for k, v in rep[path]["local_stats"].items()
                           if k != "total_spill_rows"}) for rep in reports]
    want = SpillStats.reduce_shards(local).as_dict()
    got = dict(stats[0])
    for k in EXCHANGE_FIELDS:
        got.pop(k), want.pop(k)
    if got != want:
        raise SystemExit(f"FAIL {path}: the mesh's SpillStats are not the ranks' one-device "
                         f"stats reduced:\n{got}\n{want}")
    out["d"] = dict(stats=stats[0], ranks=[{k: rep[path][k] for k in (
        "wall_s", "host_syncs", "collectives", "launches")} for rep in reports])
    log(f"phase 13d, mesh spill parity ok (card = CPU ranks = reduced one-device runs): "
        f"{json.dumps(out['d'])}")

    for path in ("mesh aggregate gloo4", "mesh merge_join", "mesh stream", "mesh service",
                 "mesh spill parity"):
        by_path[path] = {k: sum(rep[path]["launches"][k] for rep in reports)
                         for k in reports[0][path]["launches"]}
    for name, err in reports[0].get("max_err", {}).items():
        MAX_ERR[name] = max(MAX_ERR.get(name, 0.0), err)
    for path, kinds in reports[0].get("checked_shapes", {}).items():  # rank 0's checks
        CAPTURED[f"{path} rank 0"] = {k: {tuple(tuple(x) if isinstance(x, list) else x
                                                for x in sig[:-1]): [sig[-1], None]
                                          for sig in sigs} for k, sigs in kinds.items()}

    if torch.cuda.device_count() >= 2:  # part a on NCCL, one rank a card
        nreports = _spawn_mesh(run_dir, 2, "nccl", "a")
        out["a_nccl"] = check_mesh_aggregate(run_dir, nreports, q18, n_rows)
        log(f"phase 13a, NCCL world 2 ok: {json.dumps(out['a_nccl'])}")
    else:
        out["a_nccl"] = "not run: one card (NCCL needs a card a rank)"
        log("phase 13a: NCCL unverified here: one card")

    # e) the launcher, its ranks spawned by itself
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for label, extra in (("2^23 rows, Zipf 1.2", MESH_SHARD_AGG + ("--check",)),
                         ("--smoke", ("--smoke",))):
        cmd = [sys.executable, "-m", "repro_torch.launch.shard_agg", "--world",
               str(MESH_WORLD), "--dist-backend", "gloo", *extra]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        report = dict(line.split(None, 1) for line in lines[1:] if line.startswith("  "))
        if r.returncode != 0 or report.get("oracle") != "equal":
            raise SystemExit(f"FAIL shard_agg {label}: rc {r.returncode}\n{r.stdout}\n"
                             f"{r.stderr[-4000:]}")
        out[f"e {label}"] = dict(wall_s=time.perf_counter() - t0, head=lines[0], report=report)
        log(f"phase 13e, shard_agg {label} ok: {json.dumps(out[f'e {label}'])}")
    return out


# ---------------------------------------------------------------------------
# phase 14: corpus dedup, length packing and the key sorts
# ---------------------------------------------------------------------------

# llama3-8b's vocabulary; the reference's corpus shape at 2^21 documents
CORPUS = dict(vocab=128256, n_docs=1 << 21, dup_rate=0.3, max_len=512)
DEDUP_CFG = dict(memory_rows=1 << 16, batch_rows=1 << 14, page_rows=1 << 12, fanin=16)
PACK_SEQ = 4096
PACK_PREFIX = 1 << 12  # documents packed again by the reference's row scan
FINGERPRINT_SAMPLE = 4096  # documents hashed again one at a time
SORT_KEYS = 1 << 20
SORT_BATCH = (64, 4096)


def first_fit_rows(docs, seq_len: int) -> np.ndarray:
    """The reference's ``pack_by_length`` (NumPy, a scan over the rows for
    each document), the oracle of the port's max-tree first fit."""
    order = np.argsort([len(d) for d in docs])[::-1]
    rows, space = [], []
    for i in order:
        d = docs[i][:seq_len]
        for r in range(len(rows)):
            if space[r] >= len(d):
                rows[r].append(d)
                space[r] -= len(d)
                break
        else:
            rows.append([d])
            space.append(seq_len - len(d))
    out = np.full((len(rows), seq_len), -1, np.int32)
    for r, ds in enumerate(rows):
        cur = 0
        for d in ds:
            out[r, cur:cur + len(d)] = d
            cur += len(d)
    return out


def key_sorts(dev, prints: np.ndarray, by_path: dict) -> dict:
    """``ops.sort_keys`` on 2^20 fingerprints and ``bitonic_sort`` /
    ``bitonic_sort_kv`` on a (64, 4096) batch of them, each equal to its
    plain version on the CPU: one argsort launch each."""
    import torch

    from repro_torch.kernels import bitonic_sort, ops

    keys = torch.from_numpy(prints[:SORT_KEYS].astype(np.int64)).to(dev)
    t, n = SORT_BATCH
    batch = torch.from_numpy(prints[:t * n].astype(np.int64).reshape(t, n)).to(dev)
    vals = torch.arange(t * n, device=dev).view(t, n)
    ops.reset_launch_counts()
    with capture("key sorts"):
        (got, sb, (sk, sv)), wall = timed(lambda: (ops.sort_keys(keys),
                                                   bitonic_sort.bitonic_sort(batch),
                                                   bitonic_sort.bitonic_sort_kv(batch, vals)))
    launches = dict(ops.LAUNCHES)
    if launches["argsort"] != 3:
        raise SystemExit(f"FAIL key sorts: {launches['argsort']} argsort launches, expected 3")
    by_path["key sorts"] = launches
    want_k, want_v = bitonic_sort.bitonic_sort_kv(batch.cpu(), vals.cpu())
    check_equal("sort_keys", got.cpu().numpy(), ops.sort_keys(keys.cpu()).numpy())
    check_equal("bitonic_sort", sb.cpu().numpy(), want_k.numpy())
    check_equal("bitonic_sort_kv keys", sk.cpu().numpy(), want_k.numpy())
    check_equal("bitonic_sort_kv payload", sv.cpu().numpy(), want_v.numpy())
    check_equal("sort_keys against np.sort", got.cpu().numpy(), np.sort(prints[:SORT_KEYS]))
    settle("key sorts")  # phase 10 times the argsort at 2^20 keys
    return dict(keys=SORT_KEYS, batch=list(SORT_BATCH), wall_s=wall, launches=launches)


def dedup_path(dev, by_path: dict) -> dict:
    """Phase 14: ``SyntheticCorpus`` at llama3-8b's vocabulary and 2^21
    documents, its fingerprints on the card, ``dedup_examples`` (the
    in-sort DISTINCT, spilling at M = 2^16 through a wide merge), the
    kept documents packed into rows of 4,096 tokens, and the key sorts;
    the wall of each step."""
    import torch

    from repro_torch.core.operators import distinct
    from repro_torch.core.types import SYNCS, ExecConfig
    from repro_torch.data import pipeline as D
    from repro_torch.kernels import ops

    walls = {}
    t0 = time.perf_counter()
    docs = D.SyntheticCorpus(seed=SEED, **CORPUS).documents()
    walls["generation_s"] = time.perf_counter() - t0
    n_tokens = sum(len(d) for d in docs)
    prints, walls["fingerprint_s"] = timed(lambda: D.fingerprints(docs, device=dev))
    sample = np.random.default_rng(SEED).choice(len(docs), FINGERPRINT_SAMPLE, replace=False)
    check_equal("fingerprints (one document at a time)", prints[sample],
                np.asarray([D.fingerprint(docs[i]) for i in sample], np.uint32))

    cfg = ExecConfig(**DEDUP_CFG)
    ops.reset_launch_counts()
    SYNCS["host_syncs"] = 0
    torch.cuda.reset_peak_memory_stats()
    with capture("dedup"):
        (uniq, stats), walls["dedup_s"] = timed(lambda: D.dedup_examples(docs, cfg, device=dev))
    launches, syncs = dict(ops.LAUNCHES), SYNCS["host_syncs"]
    peak = torch.cuda.max_memory_allocated()
    require_launches("dedup", launches, AGG_KERNELS)
    by_path["dedup"] = launches
    keys, first = np.unique(prints, return_index=True)
    if len(uniq) != keys.size or not all(u is docs[i] for u, i in zip(uniq, first)):
        raise SystemExit(f"FAIL dedup: {len(uniq)} documents kept, {keys.size} distinct "
                         "fingerprints, or not their first occurrences in fingerprint order")
    t0 = time.perf_counter()
    _, cpu_stats = distinct(prints, cfg, output_estimate=len(docs), device="cpu")
    walls["dedup_cpu_parity_s"] = time.perf_counter() - t0
    if stats.as_dict() != cpu_stats.as_dict():
        raise SystemExit(f"FAIL dedup: SpillStats differ from the CPU run\n{stats.as_dict()}\n"
                         f"{cpu_stats.as_dict()}")
    if stats.runs_generated <= cfg.fanin or stats.rows_spilled_merge == 0:
        raise SystemExit(f"FAIL dedup: no spill through a merge level: {stats.as_dict()}")
    settle("dedup")

    packed, walls["pack_s"] = timed(lambda: D.pack_by_length(uniq, PACK_SEQ))
    kept = sum(min(len(d), PACK_SEQ) for d in uniq)
    if int((packed >= 0).sum()) != kept or packed.shape[1] != PACK_SEQ:
        raise SystemExit(f"FAIL pack: {int((packed >= 0).sum())} tokens packed of {kept}")
    check_equal("pack_by_length (first fit by row scan)",
                D.pack_by_length(uniq[:PACK_PREFIX], PACK_SEQ),
                first_fit_rows(uniq[:PACK_PREFIX], PACK_SEQ))
    sorts = key_sorts(dev, prints, by_path)
    walls["key_sorts_s"] = sorts["wall_s"]
    info = dict(docs=len(docs), tokens=n_tokens, unique_docs=len(uniq),
                unique_tokens=sum(len(d) for d in uniq), cfg=DEDUP_CFG, stats=stats.as_dict(),
                launches=launches, host_syncs=syncs, max_memory_allocated=peak,
                rows_packed=int(packed.shape[0]), fill=kept / packed.size,
                key_sorts=sorts, walls=walls)
    log(f"phase 14, corpus dedup ok: {json.dumps(info)}")
    return info


# ---------------------------------------------------------------------------
# phase 15: the dense model family's serve path
# ---------------------------------------------------------------------------

DENSE_GATE = ("llama3-8b", "qwen2-1.5b", "granite-20b")  # float32, 2 layers, card = CPU
DENSE_GATE_SERVE = dict(batch=4, prompt_len=32, gen=4)
# bfloat16 at full width: layers served (None: the published depth)
DENSE_SERVE = {"llama3-8b": None, "qwen2-1.5b": None, "granite-20b": 26,
               "mistral-large-123b": 16}


def serve_prompts(cfg, b: int, s: int):
    """Seeded prompt ids (B, S), or for a front-end stub seeded (B, S, D)
    embeddings at the scale of the reference's serve table, N(0, 0.02^2)."""
    import torch

    gen = torch.Generator().manual_seed(SEED)
    if cfg.frontend_stub:
        return torch.randn((b, s, cfg.d_model), generator=gen) * 0.02
    return torch.randint(0, cfg.vocab, (b, s), generator=gen)


def dense_gate(dev, arch: str, layers: int = 2) -> dict:
    """A float32 copy of ``arch`` at full width cut to ``layers`` served on
    the card and, on the same weights, on the CPU teacher-forced with the
    card's tokens: logits within rtol/atol 1e-3, greedy tokens equal."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cache_len, generate
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32")
    b, s, gen = (DENSE_GATE_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    prompts = serve_prompts(cfg, b, s)
    card = M.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    host = M.Model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    max_len = cache_len(cfg, s + gen)
    a = generate(card, cfg, prompts, gen=gen, max_len=max_len, keep_logits=True)
    del card
    p = generate(host, cfg, prompts, gen=gen, max_len=max_len, force=a.tokens[:, :-1],
                 keep_logits=True)
    diff = float(np.abs(a.logits - p.logits).max())
    if not np.allclose(a.logits, p.logits, rtol=1e-3, atol=1e-3):
        raise SystemExit(f"FAIL dense {arch} fp32: logits differ by {diff} (rtol/atol 1e-3)")
    check_equal(f"dense {arch} fp32 greedy tokens", a.tokens, p.tokens)
    flags = {f: getattr(cfg, f) for f in ("family", "n_kv_heads", "kv_dup", "qkv_bias", "act",
                                          "tie_embeddings", "rope", "frontend_stub")}
    return dict(layers=layers, **flags, max_abs_logit_diff=diff)


def dense_serve(dev, arch: str, layers) -> dict:
    """``arch`` in bfloat16 at full width (``layers`` of them, or all):
    seeded weights, prefill of 4 x 256 tokens (embeddings for a front-end
    stub) and greedy decode to 16; finite logits, tokens inside the
    vocabulary, and the serve's figures."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import cache_len, generate
    from repro_torch.models import model as M

    cfg = get_config(arch)
    published = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    b, s, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    prompts = serve_prompts(cfg, b, s)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    _sync()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size() for t in model.parameters())
    max_len = cache_len(cfg, s + gen)
    a = generate(model, cfg, prompts, gen=gen, max_len=max_len, keep_logits=True)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(a.logits).all():
        raise SystemExit(f"FAIL dense {arch} bf16: non-finite logits")
    if a.tokens.min() < 0 or a.tokens.max() >= cfg.vocab:
        raise SystemExit(f"FAIL dense {arch} bf16: tokens outside the vocabulary")
    prof = device_profile("prefill + 2 decode steps", lambda: generate(
        model, cfg, prompts, gen=3, max_len=cache_len(cfg, s + 3)), {})
    info = dict(arch=arch, layers=cfg.n_layers, published_layers=published, dtype=cfg.dtype,
                batch=b, prompt_len=s, gen=gen, weight_bytes=weights,
                param_count=cfg.param_count(), init_s=init_s, prefill_s=a.t_prefill,
                decode_ms_per_token=a.t_decode * 1e3, decode_tokens_per_s=b / a.t_decode,
                generated_tokens_per_s=b * gen / (a.t_prefill + (gen - 1) * a.t_decode),
                max_memory_allocated=peak, profile=prof)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return info


def dense_path(dev) -> dict:
    """Phase 15: the gate (float32, 2 layers, card = CPU) for three dense
    families, then each dense config served in bfloat16."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for arch in DENSE_GATE:
        t0 = time.perf_counter()
        out[f"{arch} fp32"] = dense_gate(dev, arch)
        out[f"{arch} fp32"]["wall_s"] = time.perf_counter() - t0
        log(f"phase 15a, dense {arch} fp32 (2 layers, full width) ok: "
            f"{json.dumps(out[f'{arch} fp32'])}")
        gc.collect()
        torch.cuda.empty_cache()
    for arch, layers in DENSE_SERVE.items():
        t0 = time.perf_counter()
        out[arch] = dense_serve(dev, arch, layers)
        out[arch]["wall_s"] = time.perf_counter() - t0
        cut = ("" if layers is None
               else f" (cut to {layers} of {out[arch]['published_layers']} layers)")
        log(f"phase 15b, dense {arch} bf16{cut} ok: {json.dumps(out[arch])}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the example programs' twins
# ---------------------------------------------------------------------------

EXAMPLES = ("torch_quickstart.py", "torch_intersect_warehouse.py",
            "torch_streaming_service.py", "torch_moe_sorted_dispatch.py")
EXAMPLE_SIZES = ("QUICKSTART_N", "INTERSECT_N", "SERVICE_MINUTES", "SERVICE_ROWS")


def examples_path() -> dict:
    """Phase 16: each example twin at its default size on the card, in its
    own process, the four at once: each must exit 0."""
    import os

    env = {k: v for k, v in os.environ.items() if k not in EXAMPLE_SIZES}
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / name)], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True) for name in EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            text, _ = proc.communicate(timeout=600)
            lines = text.strip().splitlines()
            if proc.returncode != 0:
                raise SystemExit(f"FAIL example {name}: rc {proc.returncode}\n"
                                 + "\n".join(lines[-40:]))
            out[name] = dict(done_after_s=time.perf_counter() - t0, last_lines=lines[-2:])
            log(f"phase 16, {name} ok: {json.dumps(out[name])}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


# ---------------------------------------------------------------------------
# phase 17: every remaining model family
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-v3-671b"
# bfloat16 at full width: the 3 dense-prefix layers and 2 MoE layers, 27.30 G
# parameters with MTP's (54.6 GB); the published 61 layers are 1.34 TB
DEEPSEEK_LAYERS = 5
# its float32 gate: 1 dense-prefix layer and 1 MoE layer, 14.63 G parameters (58.5 GB)
DEEPSEEK_GATE = dict(n_layers=2, first_k_dense=1)
FAMILIES = ("mamba2-2.7b", "zamba2-2.7b", "qwen2-vl-2b", "hubert-xlarge")  # bf16, published depth
# float32 gates at full width, card = CPU: layers (zamba2's 6: one group and the shared block)
FAMILY_GATE = {"mamba2-2.7b": 2, "zamba2-2.7b": 6, "qwen2-vl-2b": 2, "hubert-xlarge": 2}


def deepseek_serve(dev) -> tuple[dict, dict]:
    """deepseek-v3-671b in bfloat16 at full width cut to ``DEEPSEEK_LAYERS``:
    seeded weights, prefill of 4 x 256 tokens and greedy decode to 16
    through the kernels (launches counted from zero, inputs captured), then
    the serve's figures and the device profile of a prefill and two steps;
    the kernels held against their plain versions on the captured inputs.
    Returns the figures and the launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import cache_len, generate
    from repro_torch.models import model as M

    cfg = get_config(DEEPSEEK)
    published = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=DEEPSEEK_LAYERS)
    b, s, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    prompts = serve_prompts(cfg, b, s)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    _sync()
    init_s = time.perf_counter() - t0
    weights = sum(t.numel() * t.element_size() for t in model.parameters())
    ops.reset_launch_counts()
    with capture("deepseek"):
        a = generate(model, cfg, prompts, gen=gen, max_len=cache_len(cfg, s + gen),
                     backend="cuda", keep_logits=True)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(a.logits).all():
        raise SystemExit("FAIL deepseek bf16: non-finite logits")
    if a.tokens.min() < 0 or a.tokens.max() >= cfg.vocab:
        raise SystemExit("FAIL deepseek bf16: tokens outside the vocabulary")
    moe_layers = cfg.n_layers - cfg.moe.first_k_dense
    want = {"grouped_matmul": 3 * moe_layers * gen, "grouped_matmul_simt": 0,
            "argsort": moe_layers * gen}
    require_launches("deepseek", launches, ("grouped_matmul", "argsort"))
    if any(launches[k] != v for k, v in want.items()):
        raise SystemExit(f"FAIL deepseek: launches {launches}, expected {want}")
    prof = device_profile("prefill + 2 decode steps", lambda: generate(
        model, cfg, prompts, gen=3, max_len=cache_len(cfg, s + 3), backend="cuda"),
        {"grouped_matmul": ("grouped_matmul",), "argsort": ARGSORT_KERNELS})
    PROFILES["deepseek"] = prof
    info = dict(arch=DEEPSEEK, layers=cfg.n_layers, published_layers=published,
                dense_prefix_layers=cfg.moe.first_k_dense, dtype=cfg.dtype, batch=b,
                prompt_len=s, gen=gen, weight_bytes=weights, param_count=cfg.param_count(),
                init_s=init_s, prefill_s=a.t_prefill, decode_ms_per_token=a.t_decode * 1e3,
                decode_tokens_per_s=b / a.t_decode,
                generated_tokens_per_s=b * gen / (a.t_prefill + (gen - 1) * a.t_decode),
                max_memory_allocated=peak, launches=launches, profile=prof)
    del model, a
    gc.collect()
    torch.cuda.empty_cache()
    settle("deepseek", ("grouped_matmul", "argsort"))
    return info, launches


def deepseek_gate(dev) -> tuple[dict, dict]:
    """deepseek-v3-671b in float32 at full width cut to ``DEEPSEEK_GATE``
    (a dense-prefix layer, then an MoE layer) served with the kernels and,
    teacher-forced on the same weights, with the plain versions on the card
    (:func:`hold_gate`)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(DEEPSEEK)
    cfg = dataclasses.replace(cfg, n_layers=DEEPSEEK_GATE["n_layers"], dtype="float32",
                              moe=dataclasses.replace(
                                  cfg.moe, first_k_dense=DEEPSEEK_GATE["first_k_dense"]))
    prompts = serve_prompts(cfg, SERVE["batch"], SERVE["prompt_len"])
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    weights = sum(t.numel() * t.element_size() for t in model.parameters())
    a, p, launches, ra, rb = serve_pair(model, cfg, prompts, "deepseek fp32")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    info = dict(layers=cfg.n_layers, dense_prefix_layers=cfg.moe.first_k_dense,
                weight_bytes=weights, param_count=cfg.param_count(),
                max_abs_logit_diff=hold_gate("deepseek fp32", a, p, ra, rb),
                router_calls=len(ra), launches=launches)
    require_launches("deepseek fp32", launches, ("grouped_matmul_simt", "argsort"))
    settle("deepseek fp32")
    return info, launches


def encoder_forward(dev, arch: str) -> dict:
    """An encoder in bfloat16 at full width and published depth: its forward
    over 4 x 256 seeded frame embeddings (no decode step: ``shape_skips``),
    finite logits of the frame classes, with the wall, peak memory and the
    device's idle share."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(arch)
    frames = serve_prompts(cfg, SERVE["batch"], SERVE["prompt_len"]).to(dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    _sync()
    init_s = time.perf_counter() - t0
    M.forward(model, cfg, frames)  # warm
    _sync()
    t0 = time.perf_counter()
    logits, _, _ = M.forward(model, cfg, frames)
    _sync()
    forward_s = time.perf_counter() - t0
    if logits.shape != (*frames.shape[:2], cfg.vocab) or not torch.isfinite(logits).all():
        raise SystemExit(f"FAIL {arch} bf16: logits {tuple(logits.shape)}, finite "
                         f"{bool(torch.isfinite(logits).all())}")
    info = dict(arch=arch, layers=cfg.n_layers, dtype=cfg.dtype, frames=list(frames.shape),
                weight_bytes=sum(t.numel() * t.element_size() for t in model.parameters()),
                param_count=cfg.param_count(), init_s=init_s, forward_s=forward_s,
                frames_per_s=frames.shape[0] * frames.shape[1] / forward_s,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                profile=device_profile("forward", lambda: M.forward(model, cfg, frames), {}))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return info


def encoder_gate(dev, arch: str, layers: int) -> dict:
    """An encoder in float32 at full width cut to ``layers``: the forward
    over 4 x 256 frame embeddings on the card and, on the same weights, on
    the CPU: logits within rtol/atol 1e-3."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype="float32")
    frames = serve_prompts(cfg, SERVE["batch"], SERVE["prompt_len"])
    card = M.init(cfg, torch.Generator(device=dev).manual_seed(SEED))
    host = M.Model(cfg, device="cpu")
    host.load_state_dict(card.state_dict())
    a = M.forward(card, cfg, frames)[0].cpu().numpy()
    del card
    p = M.forward(host, cfg, frames)[0].numpy()
    diff = float(np.abs(a - p).max())
    if not np.allclose(a, p, rtol=1e-3, atol=1e-3):
        raise SystemExit(f"FAIL {arch} fp32: logits differ by {diff} (rtol/atol 1e-3)")
    return dict(layers=layers, causal=cfg.causal, act=cfg.act, max_abs_logit_diff=diff)


def family_path(dev, by_path: dict) -> dict:
    """Phase 17: deepseek-v3 served in bfloat16 (5 layers) through the
    kernels and its float32 gate (kernels = plain); mamba2, zamba2 and
    qwen2-vl served in bfloat16 at their published depth and hubert's
    forward; then the float32 gates of those four, card = CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import shape_skips

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for label, fn in (("a", deepseek_serve), ("b", deepseek_gate)):
        t0 = time.perf_counter()
        name = DEEPSEEK if label == "a" else f"{DEEPSEEK} fp32"
        out[name], by_path["deepseek" if label == "a" else "deepseek fp32"] = fn(dev)
        out[name]["wall_s"] = time.perf_counter() - t0
        log(f"phase 17{label}, {name} ok: {json.dumps(out[name])}")
        gc.collect()
        torch.cuda.empty_cache()
    for arch in FAMILIES:
        t0 = time.perf_counter()
        if shape_skips(get_config(arch), "decode_32k"):  # an encoder: no decode step
            out[arch] = encoder_forward(dev, arch)
        else:
            out[arch] = dense_serve(dev, arch, None)
        out[arch]["wall_s"] = time.perf_counter() - t0
        log(f"phase 17c, {arch} bf16 ok: {json.dumps(out[arch])}")
    for arch, layers in FAMILY_GATE.items():
        t0 = time.perf_counter()
        if shape_skips(get_config(arch), "decode_32k"):
            out[f"{arch} fp32"] = encoder_gate(dev, arch, layers)
        else:
            out[f"{arch} fp32"] = dense_gate(dev, arch, layers)
        out[f"{arch} fp32"]["wall_s"] = time.perf_counter() - t0
        log(f"phase 17d, {arch} fp32 ({layers} layers, full width) ok: "
            f"{json.dumps(out[f'{arch} fp32'])}")
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 18: training
# ---------------------------------------------------------------------------

TRAIN = dict(arch="qwen3-moe-30b-a3b", layers=4, batch=4, seq=512, steps=5, lr=5e-3)
TRAIN_GATE_LAYERS = 2  # 18b: float32, full width, kernels against plain versions
TOPK = dict(rounds=4, k=1 << 18)  # 18c: error-feedback rounds on 18a's embedding gradient
DRIVER = dict(arch="qwen3-moe-30b-a3b", steps=8, cut=4)  # 18d: smoke config, --resume
DEEPSEEK_TRAIN = dict(steps=3, batch=4, seq=64)  # 18d: deepseek-v3's smoke config, card = CPU


@contextlib.contextmanager
def gmm_phases():
    """Count the grouped-matmul launches made inside the autograd engine
    (the remat recompute and the backward's own products) apart from the
    forward's: the backward's own are ``ops.LAUNCHES["grouped_matmul_bwd"]``,
    the recompute the rest of those in the engine."""
    import torch

    from repro_torch.kernels import grouped_matmul

    counts, orig = {"in_backward": 0, "forward": 0}, grouped_matmul.grouped_matmul_launch

    def tap(*args, **kw):
        counts["in_backward" if torch._C._current_graph_task_id() >= 0 else "forward"] += 1
        return orig(*args, **kw)

    grouped_matmul.grouped_matmul_launch = tap
    try:
        yield counts
    finally:
        grouped_matmul.grouped_matmul_launch = orig


def train_batch(cfg, batch: int, seq: int, dev):
    """One batch of the ported ``DataLoader`` at the config's vocabulary."""
    from repro_torch.data import DataLoader
    from repro_torch.launch.train import make_batch

    return make_batch(cfg, DataLoader(cfg.vocab, batch, seq, seed=SEED).next(), dev)


def train_path(dev, by_path: dict) -> dict:
    """Phase 18a: qwen3-moe-30b-a3b trains at full width cut to
    ``TRAIN["layers"]`` layers in bfloat16 (AdamW with float32 moments,
    remat, sorted dispatch through the kernels): the same batch for 5 steps
    at lr 5e-3; every loss and gradient norm finite and the last loss below
    the first; launches by phase; then one step under the profiler and the
    path's kernels against their plain versions (the backward's products
    among them).  Returns the model (18c reads its embedding gradient)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=TRAIN["layers"])
    step, init_state, opt = ST.make_train_step(cfg, lr=TRAIN["lr"], backend="cuda")
    if opt != "adamw" or not cfg.remat:
        raise SystemExit(f"FAIL train: optimizer {opt}, remat {cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device=dev).manual_seed(SEED))
    _sync()
    init_s = time.perf_counter() - t0
    batch = train_batch(cfg, TRAIN["batch"], TRAIN["seq"], dev)
    state_bytes = sum(t.numel() * t.element_size() for t in state.params.parameters())
    moment_bytes = sum(t.numel() * t.element_size() for t in (*state.opt_m.values(),
                                                              *state.opt_v.values()))
    losses, norms, step_s = [], [], []
    ops.reset_launch_counts()
    with capture("train"), gmm_phases() as phases:
        for _ in range(TRAIN["steps"]):
            t0 = time.perf_counter()
            state, met = step(state, batch)
            losses.append(float(met["loss"]))  # a sync: the step's end
            norms.append(float(met["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise SystemExit(f"FAIL train: losses {losses}, gradient norms {norms}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL train: the loss did not fall: {losses}")
    moe = cfg.n_layers * TRAIN["steps"]  # MoE layer-steps
    bwd = launches["grouped_matmul_bwd"]
    by_phase = dict(forward=phases["forward"], recompute=phases["in_backward"] - bwd,
                    backward=bwd)
    want = dict(forward=3 * moe, recompute=3 * moe, backward=6 * moe)
    require_launches("train", launches, ("grouped_matmul", "argsort", "grouped_matmul_bwd"))
    if (by_phase != want or launches["grouped_matmul_simt"]
            or launches["argsort"] != 2 * moe):
        raise SystemExit(f"FAIL train: grouped matmuls by phase {by_phase} (expected {want}), "
                         f"launches {launches} (argsort {2 * moe}, no CUDA-core product)")
    prof = device_profile("one train step", lambda: float(step(state, batch)[1]["loss"]),
                          {"grouped_matmul": ("grouped_matmul",), "argsort": ARGSORT_KERNELS})
    PROFILES["train"] = prof
    info = dict(arch=cfg.name, layers=cfg.n_layers, dtype=cfg.dtype, optimizer=opt,
                remat=cfg.remat, batch=TRAIN["batch"], seq=TRAIN["seq"], lr=TRAIN["lr"],
                param_count=sum(t.numel() for t in state.params.parameters()),
                param_bytes=state_bytes, moment_bytes=moment_bytes, init_s=init_s,
                losses=losses, grad_norms=norms, step_ms=[t * 1e3 for t in step_s],
                ms_per_step_after_first=float(np.mean(step_s[1:])) * 1e3,
                max_memory_allocated=peak, launches=launches,
                grouped_matmul_by_phase=by_phase, profile=prof)
    by_path["train"] = launches
    log(f"phase 18a, train ok: {json.dumps(info)}")
    settle("train", ("grouped_matmul", "argsort"))
    return state.params, info


def topk_path(dev, model, by_path: dict) -> dict:
    """Phase 18c: ``TOPK["rounds"]`` error-feedback rounds of
    ``compress_topk`` on 18a's embedding gradient (each round's picks are
    the largest |grad + residual|, the residual the rest), then
    ``aggregate_sparse`` over all the rounds' pairs through the argsort and
    the segmented combine, against ``np.add.at``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.optim import compression as C

    cfg = model.cfg
    batch = train_batch(cfg, TRAIN["batch"], TRAIN["seq"], dev)
    for t in model.parameters():
        t.requires_grad_(t is model.embed)
    loss, _ = M.lm_loss(model, cfg, batch["tokens"], batch["labels"], backend="cuda")
    loss.backward()
    g = model.embed.grad.reshape(-1)
    model.embed.grad = None
    st = C.init_topk(g)
    idx_all, val_all = [], []
    for r in range(TOPK["rounds"]):
        acc = g.float() + st.residual
        idx, val, st = C.compress_topk(g, st, TOPK["k"])
        back = st.residual.clone()
        back[idx] = val
        if not torch.equal(back, acc) or float(st.residual.abs().max()) > float(
                val.abs().min()):
            raise SystemExit(f"FAIL topk round {r}: the picks are not the largest entries of "
                             "grad + residual, or the residual is not the rest")
        idx_all.append(idx)
        val_all.append(val)
    idx, val = torch.cat(idx_all), torch.cat(val_all)
    n = g.numel()
    ops.reset_launch_counts()
    with capture("topk"):
        t0 = time.perf_counter()
        dense = C.aggregate_sparse(idx, val, n, backend="cuda")
        _sync()
        wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    require_launches("topk", launches, ("argsort", "segmented_combine"))
    want = np.zeros(n, np.float64)
    hi, hv = idx.cpu().numpy(), val.cpu().numpy()
    np.add.at(want, hi, hv.astype(np.float64))
    bound = 2 * hv.size * 2.0 ** -24 * float(np.abs(hv).sum())
    diff = float(np.abs(dense.cpu().numpy() - want).max())
    if diff > bound:
        raise SystemExit(f"FAIL topk aggregate_sparse: {diff} from np.add.at (bound {bound})")
    info = dict(entries=n, k=TOPK["k"], rounds=TOPK["rounds"], pairs=int(hi.size),
                distinct=int(np.unique(hi).size), max_abs_diff=diff, bound=bound,
                aggregate_wall_ms=wall * 1e3, launches=launches)
    by_path["topk"] = launches
    log(f"phase 18c, top-k compression ok: {json.dumps(info)}")
    settle("topk", ("argsort", "segmented_combine"))
    return info


def leaf_close(name: str, got, want, tol: float = 1e-3) -> float:
    """Fail unless ``got`` is within ``tol`` of ``want``'s largest
    magnitude; returns the ratio of the largest difference to that bound."""
    got, want = got.detach(), want.detach()
    scale = float(want.abs().max())
    diff = float((got.float() - want.float()).abs().max())
    if diff > tol * max(scale, 1e-6):
        raise SystemExit(f"FAIL {name}: differs by {diff} (bound {tol} x {scale})")
    return diff / (tol * max(scale, 1e-6))


def train_gate(dev) -> dict:
    """Phase 18b: qwen3-moe-30b-a3b in float32 at full width cut to
    ``TRAIN_GATE_LAYERS``, from the same seeded weights and batch: the loss
    and every gradient leaf with the kernels and with the plain versions on
    the card (loss rtol 1e-5, leaves within 1e-3 of their largest
    magnitude, routes equal), then one train step each and the updated
    parameters within the same bound."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=TRAIN_GATE_LAYERS,
                              dtype="float32")
    batch = train_batch(cfg, TRAIN["batch"], TRAIN["seq"], dev)
    model = M.trainable(M.init(cfg, torch.Generator(device=dev).manual_seed(SEED)))
    out, grads, rts = {}, {}, {}
    ops.reset_launch_counts()
    for backend in ("cuda", "torch"):
        with (capture("train fp32") if backend == "cuda" else contextlib.nullcontext()), \
                routes() as rt:
            loss, _ = M.lm_loss(model, cfg, batch["tokens"], batch["labels"], backend=backend)
            loss.backward()
        out[backend], rts[backend] = float(loss.detach()), rt
        grads[backend] = {n: t.grad for n, t in model.named_parameters()}
        for t in model.parameters():
            t.grad = None
        if backend == "cuda":
            launches = dict(ops.LAUNCHES)
    require_launches("train fp32", launches, ("grouped_matmul_simt", "argsort",
                                              "grouped_matmul_bwd"))
    if not all(torch.equal(a, b) for a, b in zip(rts["cuda"], rts["torch"])):
        raise SystemExit("FAIL train fp32: the kernels and the plain versions routed tokens "
                         "to different experts")
    if not math.isclose(out["cuda"], out["torch"], rel_tol=1e-5):
        raise SystemExit(f"FAIL train fp32: loss {out['cuda']} with the kernels, "
                         f"{out['torch']} with the plain versions (rtol 1e-5)")
    grad_ratio = max(leaf_close(f"train fp32 grad {n}", g, grads["torch"][n])
                     for n, g in grads["cuda"].items() if g is not None)
    del grads, model
    gc.collect()
    updated = {}
    for backend in ("cuda", "torch"):
        step, init_state, _ = ST.make_train_step(cfg, lr=TRAIN["lr"], backend=backend)
        state = init_state(torch.Generator(device=dev).manual_seed(SEED))
        state, _ = step(state, batch)
        updated[backend] = state.params
        del state
        gc.collect()
    param_ratio = max(leaf_close(f"train fp32 updated {n}", t, dict(
        updated["torch"].named_parameters())[n]) for n, t in updated["cuda"].named_parameters())
    del updated
    gc.collect()
    torch.cuda.empty_cache()
    info = dict(layers=cfg.n_layers, dtype=cfg.dtype, loss_kernels=out["cuda"],
                loss_plain=out["torch"], router_calls=len(rts["cuda"]),
                worst_grad_share_of_bound=grad_ratio, worst_param_share_of_bound=param_ratio,
                launches=launches)
    log(f"phase 18b, train fp32 gate ok: {json.dumps(info)}")
    settle("train fp32")
    return info


def _driver(ckpt: Path, steps: int, *extra: str) -> subprocess.Popen:
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", DRIVER["arch"], "--smoke",
         "--steps", str(steps), "--ckpt", str(ckpt), "--log-every", "1", *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _driver_losses(name: str, proc: subprocess.Popen) -> list[float]:
    text, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"FAIL train driver {name}: rc {proc.returncode}\n{text[-4000:]}")
    return [float(line.split("loss=")[1].split()[0]) for line in text.splitlines()
            if line.startswith("step ")]


def deepseek_train(dev) -> dict:
    """deepseek-v3's smoke config (MLA, a dense prefix, MoE through the
    kernels, MTP) trained ``DEEPSEEK_TRAIN["steps"]`` steps on the card and
    on the CPU from the same weights and batch: losses within rtol 1e-3,
    parameters within 1e-3 of each leaf's largest magnitude."""
    import copy

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST

    cfg = get_config(DEEPSEEK, smoke=True)
    step, init_state, _ = ST.make_train_step(cfg, lr=TRAIN["lr"])
    cpu = init_state(torch.Generator().manual_seed(SEED))
    card = ST.TrainState(copy.deepcopy(cpu.params).to(dev),
                         {k: v.to(dev, copy=True) for k, v in cpu.opt_m.items()},
                         {k: v.to(dev, copy=True) for k, v in cpu.opt_v.items()}, 0)
    losses = {}
    ops.reset_launch_counts()
    for name in ("cuda", "cpu"):
        st = card if name == "cuda" else cpu
        batch = train_batch(cfg, DEEPSEEK_TRAIN["batch"], DEEPSEEK_TRAIN["seq"],
                            dev if name == "cuda" else torch.device("cpu"))
        losses[name] = []
        for _ in range(DEEPSEEK_TRAIN["steps"]):
            st, met = step(st, batch)
            losses[name].append(float(met["loss"]))
        if name == "cuda":
            card, launches = st, dict(ops.LAUNCHES)
        else:
            cpu = st
    require_launches("deepseek train", launches, ("grouped_matmul_simt", "argsort",
                                                  "grouped_matmul_bwd"))
    if not np.allclose(losses["cuda"], losses["cpu"], rtol=1e-3, atol=0):
        raise SystemExit(f"FAIL deepseek train: losses {losses} (rtol 1e-3)")
    cpu_params = dict(cpu.params.named_parameters())
    ratio = max(leaf_close(f"deepseek train {n}", t.cpu(), cpu_params[n])
                for n, t in card.params.named_parameters())
    return dict(steps=DEEPSEEK_TRAIN["steps"], losses=losses, worst_param_share_of_bound=ratio,
                launches=launches)


def driver_path(dev, out: dict) -> dict:
    """Phase 18d: ``python -m repro_torch.launch.train`` on the smoke
    config, once for ``DRIVER["steps"]`` steps and once stopped at
    ``DRIVER["cut"]`` and resumed with ``--resume``: the resumed run's losses
    and its final checkpoint (model, moments, step, loader cursor) equal the
    uninterrupted run's bit for bit.  While the driver's processes start
    (most of their time: a fresh process's first step takes ~12 s on the
    card), this process runs 18b into ``out["b"]`` and deepseek-v3's smoke
    config, card against CPU; neither is timed."""
    import shutil

    root = ROOT / "build" / "train_phase"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    full = _driver(root / "full", DRIVER["steps"])
    cut = _driver(root / "cut", DRIVER["cut"])
    resumed = None
    try:
        out["b"] = train_gate(dev)
        deepseek = deepseek_train(dev)
        log(f"phase 18d, deepseek-v3 smoke train card = CPU ok: {json.dumps(deepseek)}")
        first = _driver_losses("cut", cut)
        resumed = _driver(root / "cut", DRIVER["steps"], "--resume")
        want = _driver_losses("full", full)
        rest = _driver_losses("resume", resumed)
    finally:
        for proc in [p for p in (full, cut, resumed) if p is not None]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if first + rest != want:
        raise SystemExit(f"FAIL train driver: {first} + {rest} != {want}")
    last = f"step_{DRIVER['steps']:08d}"
    with np.load(root / "full" / last / "shard_p0.npz") as a, \
            np.load(root / "cut" / last / "shard_p0.npz") as b:
        if sorted(a.files) != sorted(b.files) or not all(np.array_equal(a[k], b[k])
                                                         for k in a.files):
            raise SystemExit("FAIL train driver: the resumed run's checkpoint differs")
        leaves = len(a.files)
    info = dict(arch=DRIVER["arch"], steps=DRIVER["steps"], cut=DRIVER["cut"], losses=want,
                checkpoint_leaves=leaves, wall_s=time.perf_counter() - t0, deepseek=deepseek)
    log(f"phase 18d, train driver resumed bit for bit: {json.dumps(info)}")
    shutil.rmtree(root, ignore_errors=True)
    return info


def training_path(dev, by_path: dict) -> dict:
    """Phase 18: 18a, 18c on 18a's model, then 18d with 18b run while the
    driver's processes start (after every timed part)."""
    import torch

    out = {}
    model, out["a"] = train_path(dev, by_path)
    out["c"] = topk_path(dev, model, by_path)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["d"] = driver_path(dev, out)
    return out


# ---------------------------------------------------------------------------
# phase 19: expert parallelism on a data x model mesh of ranks
# ---------------------------------------------------------------------------

EP_WORLD = 4
EP_AXES = ("data", "model")
EP_SERVE = dict(layers=12, batch=4, prompt_len=256, gen=16)  # a: mesh (1, ranks), bf16
EP_GATE = dict(layers=2, mesh=(2, 2), prompt_len=32, gen=4)  # b: float32, full width
EP_GRAD = dict(batch=4, seq=16)  # c: one MoE layer, float32, on part a's mesh (E_loc 32)
EP_RING = dict(seq=8192, d=2048, f=6144)  # d: x sharded by sequence, w replicated
EP_PIPE = dict(layers=8, d=2048, batch=64, microbatches=8)  # e: 4 stages, float32
EP_KERNELS = ("argsort", "grouped_matmul")
EP_KERNELS_FP32 = ("argsort", "grouped_matmul_simt")  # float32 products run on the CUDA cores


def leaf_err(name: str, got, want, tol: float) -> float:
    """Largest |got - want| over ``want``'s largest magnitude; fails above
    ``tol``."""
    import torch

    scale = max(float(want.abs().max()), 1e-12)
    err = float((got.float() - want.float()).abs().max()) / scale
    if not err <= tol or not bool(torch.isfinite(got).all()):
        raise SystemExit(f"FAIL {name}: {err} of the largest magnitude (tolerance {tol})")
    return err


def _wall(fn, reps: int = 3) -> tuple[object, float]:
    """``fn()`` once to warm, then the mean wall of ``reps`` calls, each
    ending in a device sync."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def ep_rank(rank: int, world: int, rdv: str, run_dir: str, backend: str, parts: str) -> None:
    """One rank of phase 19 (``torch.multiprocessing`` target): join the
    ranks over ``backend``, make the meshes, run ``parts`` ("abcde"), write
    the rank's report under ``run_dir``.  Any failure raises, which fails
    the parent."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import moe_parallel as MP
    from repro_torch.distributed import sharding
    from repro_torch.distributed.overlap import reference_allgather_matmul, ring_allgather_matmul
    from repro_torch.distributed.pipeline import bubble_fraction, make_pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import cache_len, generate
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    sharding.init_distributed(backend=backend, num_processes=world, process_id=rank,
                              init_method=f"file://{rdv}", timeout_s=900)
    dev = torch.device("cuda", torch.cuda.current_device())
    serve_mesh = sharding.make_mesh((1, world), EP_AXES, device=dev)
    square = sharding.make_mesh(EP_GATE["mesh"], EP_AXES, device=dev) if world == 4 else None
    ring_mesh = sharding.make_mesh((world,), ("model",), device=dev)
    pipe_mesh = sharding.make_mesh((world,), ("pod",), device=dev)
    tall = sharding.make_mesh((world, 1), EP_AXES, device=dev)  # phase 20c
    shard_meshes = {(2, 2): square, (1, world): serve_mesh, (world, 1): tall}
    whole = serve_mesh.sub(EP_AXES)
    d = Path(run_dir)
    tag = f"{backend}{world}"
    report: dict = {"rank": rank, "world": world, "backend": backend, "device": str(dev)}
    cfg = dataclasses.replace(get_config(SERVE["arch"]), mesh_axes=EP_AXES)
    host = torch.Generator().manual_seed(SEED)

    def seeded(seed: int):
        return torch.Generator(device=dev).manual_seed(seed)

    def rows(t, mesh):  # this rank's data shard of a global batch (leading axis)
        dp = mesh.sub("data")
        n = t.shape[0] // dp.world
        return t[dp.rank * n:(dp.rank + 1) * n]

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # a) qwen3-moe at full width, cut to 12 of 48 layers, bf16, mesh (1, ranks)
    s, gen, b = EP_SERVE["prompt_len"], EP_SERVE["gen"], EP_SERVE["batch"]
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=host)
    cfg_a = dataclasses.replace(cfg, n_layers=EP_SERVE["layers"])
    if "a" in parts:
        MP.set_current_mesh(serve_mesh)
        t0 = time.perf_counter()
        model = M.init(cfg_a, seeded(SEED), mesh=serve_mesh)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0

        def part_a():
            out = generate(model, cfg_a, rows(prompts, serve_mesh), gen=gen,
                           max_len=cache_len(cfg_a, s + gen), backend="cuda", keep_logits=True)
            return out, dict(prefill_s=out.t_prefill, decode_ms_per_token=out.t_decode * 1e3)

        path = f"ep serve {tag}"
        out = _mesh_part(report, path, rank, whole, EP_KERNELS, part_a)
        if not np.isfinite(out.logits).all():
            raise SystemExit(f"FAIL {path} rank {rank}: non-finite logits")
        launches = report[path]["launches"]
        want = {"grouped_matmul": 3 * cfg_a.n_layers * gen, "grouped_matmul_simt": 0,
                "argsort": cfg_a.n_layers * gen}
        if any(launches[k] != v for k, v in want.items()):
            raise SystemExit(f"FAIL {path} rank {rank}: launches {launches}, expected {want}")
        report[path].update(
            tokens=out.tokens.tolist(), init_s=init_s, layers=cfg_a.n_layers,
            weight_bytes=sum(t.numel() * t.element_size() for t in model.parameters()),
            experts_held=int(model.layers[0].moe.wi.shape[0]),
            collectives_per_step={k: v / gen for k, v in report[path]["collectives"].items()})
        if rank == 0:
            shown = {k: v for k, v in report[path].items() if k != "tokens"}
            log(f"phase 19a rank 0: {json.dumps(shown)}")
        del model, out
        free()

    if "b" in parts:
        # b) float32, 2 layers at full width on (2, 2): the kernels against the
        # plain versions on the same ranks; at capacity factor E/k (no row
        # drops) against a one-process sorted run on rank 0
        mesh = square
        MP.set_current_mesh(mesh)
        gs, gg = EP_GATE["prompt_len"], EP_GATE["gen"]
        cfg_b = dataclasses.replace(cfg, n_layers=EP_GATE["layers"], dtype="float32")
        model = M.init(cfg_b, seeded(SEED), mesh=mesh)
        local = rows(prompts[:, :gs], mesh)
        kw = dict(gen=gg, max_len=cache_len(cfg_b, gs + gg), keep_logits=True)

        def part_b():
            with routes() as ra:
                a = generate(model, cfg_b, local, backend="cuda", **kw)
            return (a, ra), {}

        a, ra = _mesh_part(report, "ep fp32 gate", rank, mesh.sub(EP_AXES), EP_KERNELS_FP32,
                           part_b)
        with routes() as rb:
            p = generate(model, cfg_b, local, backend="torch", force=a.tokens[:, :-1], **kw)
        report["ep fp32 gate"]["max_abs_logit_diff"] = hold_gate(
            f"ep fp32 gate rank {rank}", a, p, ra, rb)
        report["ep fp32 gate"]["router_calls"] = len(ra)
        del model, a, p
        free()
        m = cfg.moe
        cfg_nd = dataclasses.replace(cfg_b, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
        # the forward over prompt and forced tokens (no decode cache: the
        # serve path's bfloat16 K/V would round float32 noise to bf16 ulps)
        tokens = torch.cat([prompts[:, :gs], torch.randint(0, cfg.vocab, (b, gg - 1),
                                                           generator=host)], 1).to(dev)
        model = M.init(cfg_nd, seeded(SEED), mesh=mesh)
        got = M.forward(model, cfg_nd, rows(tokens, mesh), backend="cuda")[0]
        del model
        free()
        got = sharding.all_gather(mesh.sub(EP_AXES), got)
        if rank == 0:
            plain_cfg = dataclasses.replace(cfg_nd, mesh_axes=None)
            one = M.init(plain_cfg, seeded(SEED))
            ref = M.forward(one, plain_cfg, tokens, backend="cuda")[0]
            del one
            errs, half = [], b // EP_GATE["mesh"][0]
            for r in range(world):  # rank r holds data shard r // (model ranks)
                dr = r // EP_GATE["mesh"][1]
                want_r = ref[dr * half:(dr + 1) * half]
                errs.append(float((got[r] - want_r).abs().max()))
                if not torch.allclose(got[r], want_r, rtol=1e-5, atol=1e-5):
                    raise SystemExit(f"FAIL ep fp32 no-drop: rank {r}'s logits differ from the "
                                     f"one-process sorted run by {errs[-1]} (rtol/atol 1e-5)")
            report["ep fp32 gate"].update(no_drop_max_abs_logit_diff=max(errs),
                                          no_drop_max_abs_logit=float(ref.abs().max()))
        del got
        free()

        # c) one MoE layer at full width, float32, forward and backward on
        # (1, ranks) against the one-process sorted block (capacity factor E/k)
        mesh = serve_mesh
        MP.set_current_mesh(mesh)

        def grads(moe, x, ct, dispatch, c):
            for t in moe.parameters():
                t.requires_grad_(True)
            x = x.clone().requires_grad_(True)
            y, _ = MOE.moe_block(moe, c, x, dispatch=dispatch, backend="cuda")
            (y * ct).sum().backward()
            return y.detach(), x.grad

        bsz, seq = EP_GRAD["batch"], EP_GRAD["seq"]
        x = torch.randn((bsz, seq, cfg.d_model), generator=seeded(SEED + 2), device=dev)
        ct = torch.randn((bsz, seq, cfg.d_model), generator=seeded(SEED + 3), device=dev)
        part = MOE.MoE(cfg_nd, dtype=torch.float32, device=dev, gen=seeded(SEED + 1),
                       experts=MP.expert_slice(cfg_nd, mesh))

        def part_c():
            y, dx = grads(part, rows(x, mesh), rows(ct, mesh), "sorted_ep", cfg_nd)
            return (y, dx), dict(grouped_matmul_bwd=ops.LAUNCHES["grouped_matmul_bwd"])

        y, dx = _mesh_part(report, "ep grad", rank, mesh.sub(EP_AXES), EP_KERNELS_FP32, part_c)
        full = MOE.MoE(cfg_nd, dtype=torch.float32, device=dev, gen=seeded(SEED + 1))
        y_ref, dx_ref = grads(full, x, ct, "sorted", dataclasses.replace(cfg_nd, mesh_axes=None))
        lo, hi = MP.expert_slice(cfg_nd, mesh)
        errs = {"y": leaf_err(f"ep grad rank {rank} y", y, rows(y_ref, mesh), 1e-3),
                "dx": leaf_err(f"ep grad rank {rank} dx", dx, rows(dx_ref, mesh), 1e-3),
                "router": leaf_err(f"ep grad rank {rank} router", part.router.kernel.grad,
                                   full.router.kernel.grad[:, lo:hi], 1e-3)}
        for leaf in ("wi", "wg", "wo"):
            errs[leaf] = leaf_err(f"ep grad rank {rank} {leaf}", getattr(part, leaf).grad,
                                  getattr(full, leaf).grad[lo:hi], 1e-3)
        report["ep grad"]["errors"] = errs
        if rank == 0:
            log(f"phase 19b-c rank 0: {json.dumps(report['ep fp32 gate'])} "
                f"{json.dumps(report['ep grad'])}")
        del part, full, x, ct, y, dx, y_ref, dx_ref
        free()

    if "d" in parts:
        # d) the ring all-gather matmul against the all-gather and x @ w
        ring = ring_mesh.sub("model")
        x = torch.randn((EP_RING["seq"], EP_RING["d"]), generator=seeded(SEED + 4), device=dev)
        w = torch.randn((EP_RING["d"], EP_RING["f"]), generator=seeded(SEED + 5),
                        device=dev) / EP_RING["d"] ** 0.5
        x_loc = x[ring.rank * (x.shape[0] // world):(ring.rank + 1) * (x.shape[0] // world)]
        before = dict(sharding.COLLECTIVES)
        y_ring = ring_allgather_matmul(ring_mesh)(x_loc, w)
        counts = {k: sharding.COLLECTIVES[k] - before[k] for k in sharding.KINDS}
        if counts["ppermute"] != world - 1 or counts["all_gather"]:
            raise SystemExit(f"FAIL ep ring rank {rank}: collectives {counts}")
        y_full, full_s = _wall(lambda: x @ w)
        y_gath, gath_s = _wall(lambda: reference_allgather_matmul(ring_mesh)(x_loc, w))
        _, ring_s = _wall(lambda: ring_allgather_matmul(ring_mesh)(x_loc, w))
        errs = {}
        for name, want_y in (("x @ w", y_full), ("all-gather matmul", y_gath)):
            errs[name] = float((y_ring - want_y).abs().max())
            if not torch.allclose(y_ring, want_y, rtol=1e-4, atol=1e-4):
                raise SystemExit(f"FAIL ep ring rank {rank}: differs from {name} by "
                                 f"{errs[name]} (rtol/atol 1e-4)")
        report["ep ring"] = dict(shape=[EP_RING["seq"], EP_RING["d"], EP_RING["f"]],
                                 collectives=counts, ring_s=ring_s, all_gather_matmul_s=gath_s,
                                 one_matmul_s=full_s, max_abs_diff=errs)
        del x, w, x_loc, y_ring, y_full, y_gath
        free()

    if "e" in parts:
        # e) the GPipe pipeline over 4 stages against the sequential model
        n, dm, bsz = EP_PIPE["layers"], EP_PIPE["d"], EP_PIPE["batch"]
        stages = pipe_mesh.sub("pod")
        params = torch.randn((n, dm, dm), generator=seeded(SEED + 6), device=dev) / dm ** 0.5
        x = torch.randn((bsz, dm), generator=seeded(SEED + 7), device=dev)
        ct = torch.randn((bsz, dm), generator=seeded(SEED + 8), device=dev)
        per = n // world
        mine = params[stages.rank * per:(stages.rank + 1) * per].clone().requires_grad_(True)
        pipe = make_pipeline(pipe_mesh, lambda wl, h: torch.tanh(h @ wl), n,
                             microbatches=EP_PIPE["microbatches"])
        t0 = time.perf_counter()
        y = pipe(mine, x)
        (y * ct).sum().backward()
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        seq_p = params.clone().requires_grad_(True)
        h = x
        for layer in range(n):
            h = torch.tanh(h @ seq_p[layer])
        (h * ct).sum().backward()
        y, h = y.detach(), h.detach()
        if not torch.allclose(y, h, rtol=1e-5, atol=1e-5):
            raise SystemExit(f"FAIL ep pipeline rank {rank}: output differs by "
                             f"{float((y - h).abs().max())} (rtol/atol 1e-5)")
        g_want = seq_p.grad[stages.rank * per:(stages.rank + 1) * per]
        if not torch.allclose(mine.grad, g_want, rtol=1e-4, atol=1e-4):
            raise SystemExit(f"FAIL ep pipeline rank {rank}: gradient differs by "
                             f"{float((mine.grad - g_want).abs().max())} (rtol/atol 1e-4)")
        bubble = bubble_fraction(world, EP_PIPE["microbatches"])
        if abs(bubble - 3 / 11) > 1e-12:
            raise SystemExit(f"FAIL ep pipeline: bubble fraction {bubble}")
        report["ep pipeline"] = dict(
            wall_s=pipe_s, bubble_fraction=bubble,
            max_abs_diff=float((y - h).abs().max()),
            max_abs_grad_diff=float((mine.grad - g_want).abs().max()))
        del params, x, ct, mine, y, h, seq_p
        free()
    if "f" in parts:  # phase 20 on the same ranks
        shard_path_rank(rank, shard_meshes, dev, report)
    MP.set_current_mesh(None)
    if rank == 0:  # rank 0's captured inputs against the plain versions, the serve's timed
        before = dict(MAX_ERR)
        for path in list(CAPTURED):
            timed = {"sharded train": ("grouped_matmul", "argsort")}.get(
                path, ("grouped_matmul",) if path.startswith("ep serve") else ())
            settle(path, timed)
        report["max_err"] = {k: v for k, v in MAX_ERR.items() if v != before.get(k)}
        report["checked_shapes"] = {
            p: {k: [list(key) + [calls] for key, (calls, _) in sigs.items()]
                for k, sigs in kinds.items() if sigs} for p, kinds in CAPTURED.items()}
        report["times"] = TIMES
    (d / f"ep_report_{tag}_{rank}.json").write_text(json.dumps(report))


def _spawn_ep(run_dir: Path, world: int, backend: str, parts: str) -> list[dict]:
    import torch.multiprocessing as mp

    tag = f"{backend}{world}"
    t0 = time.perf_counter()
    mp.start_processes(ep_rank, args=(world, str(run_dir / f"rendezvous_ep_{tag}"),
                                      str(run_dir), backend, parts),
                       nprocs=world, start_method="spawn")
    log(f"phase 19: {world} {backend} ranks ran parts {parts} in "
        f"{time.perf_counter() - t0:.1f} s")
    return [json.loads((run_dir / f"ep_report_{tag}_{r}.json").read_text())
            for r in range(world)]


def _ep_serve_summary(reports: list[dict]) -> dict:
    tag = f"{reports[0]['backend']}{len(reports)}"
    path = f"ep serve {tag}"
    _same_on_ranks(f"{path} greedy tokens", [rep[path]["tokens"] for rep in reports])
    keys = ("wall_s", "prefill_s", "decode_ms_per_token", "max_memory_allocated",
            "collectives_per_step", "launches", "host_syncs", "init_s", "weight_bytes",
            "experts_held")
    return dict(arch=SERVE["arch"], layers=reports[0][path]["layers"], dtype="bfloat16",
                mesh=[1, len(reports)], batch=EP_SERVE["batch"],
                prompt_len=EP_SERVE["prompt_len"], gen=EP_SERVE["gen"],
                tokens_equal_on_ranks=True,
                ranks=[{k: rep[path][k] for k in keys} for rep in reports])


def ep_path(by_path: dict) -> dict:
    """Phase 19: expert parallelism, the ring matmul and the pipeline on 4
    ranks that share the card over gloo (parts a-e), part a again on NCCL
    where there are two cards."""
    import torch

    run_dir = ROOT / "build" / "ep_phase"
    if run_dir.exists():
        for p in run_dir.iterdir():
            p.unlink()
    run_dir.mkdir(parents=True, exist_ok=True)
    out: dict = {}
    reports = _spawn_ep(run_dir, EP_WORLD, "gloo", "abcdef")
    out["a"] = _ep_serve_summary(reports)
    log(f"phase 19a, ep serve ok: {json.dumps(out['a'])}")
    for part, path in (("b", "ep fp32 gate"), ("c", "ep grad"), ("d", "ep ring"),
                       ("e", "ep pipeline")):
        out[part] = dict(ranks=[rep[path] for rep in reports])
        if part == "b":
            out[part]["no_drop_max_abs_logit_diff"] = reports[0][path][
                "no_drop_max_abs_logit_diff"]
        log(f"phase 19{part}, {path} ok: {json.dumps(out[part])}")
    out["phase 20"] = _shard_summary(reports)
    for part in "abcd":
        log(f"phase 20{part}, {PHASE20[part]} ok: {json.dumps(out['phase 20'][part])}")
    log(f"phase 20: wall by part and rank {json.dumps(out['phase 20']['wall_s'])}")
    for path in ("ep serve gloo4", "ep fp32 gate", "ep grad", "sharded train"):
        by_path[path] = {k: sum(rep[path]["launches"][k] for rep in reports)
                         for k in reports[0][path]["launches"]}
    for name, err in reports[0].get("max_err", {}).items():
        MAX_ERR[name] = max(MAX_ERR.get(name, 0.0), err)
    for path, kinds in reports[0].get("checked_shapes", {}).items():  # rank 0's checks
        CAPTURED[f"{path} rank 0"] = {k: {tuple(tuple(x) if isinstance(x, list) else x
                                                for x in sig[:-1]): [sig[-1], None]
                                          for sig in sigs} for k, sigs in kinds.items()}
    for path, kinds in reports[0].get("times", {}).items():
        TIMES[f"{path} rank 0"] = kinds
        log(f"phase 19, {path} rank 0 timed: {json.dumps(kinds)}")
    if torch.cuda.device_count() >= 2:  # part a on NCCL, one rank a card
        out["a_nccl"] = _ep_serve_summary(_spawn_ep(run_dir, 2, "nccl", "a"))
        log(f"phase 19a, NCCL world 2 ok: {json.dumps(out['a_nccl'])}")
    else:
        out["a_nccl"] = "not run: one card (NCCL needs a card a rank)"
        log("phase 19a: NCCL unverified here: one card")
    return out


# ---------------------------------------------------------------------------
# phase 20: parameters, moments and batches sharded by the logical-axis rules
# ---------------------------------------------------------------------------

SHARD_TRAIN = dict(layers=4, mesh=(2, 2), batch=4, seq=512, steps=5, lr=5e-3)  # a: bf16
SHARD_GATE = dict(layers=2, batch=4, seq=64, lr=5e-3)  # b: float32, (2, 2) and (1, 4)
SHARD_DENSE = dict(arch="llama3-8b", layers=2)  # b: full width, no kernel, on (2, 2)
SHARD_DRIVER = dict(arch="qwen3-moe-30b-a3b", steps=8, cut=4, batch=8, seq=64)  # d
PHASE20 = {"a": "sharded train", "b": "sharded fp32 gate", "c": "elastic restore",
           "d": "sharded train driver"}


def _shard_gmm_flops():
    """Tap the grouped matmul's launch function: ``2 * rows * K * N`` of
    every product (forward, recompute and the backward's), which
    ``FlopCounterMode`` does not see (the kernel is launched outside
    PyTorch's operators)."""
    from repro_torch.kernels import grouped_matmul

    total, orig = [0.0], grouped_matmul.grouped_matmul_launch

    def tap(x, w, **kw):
        total[0] += 2.0 * x.shape[0] * w.shape[1] * w.shape[2]
        return orig(x, w, **kw)

    return total, orig, tap


def _at_rest(cfg, mesh) -> tuple[int, int]:
    """Bytes a rank holds at rest by the spec arithmetic: each leaf's shard
    (``sharding.shard_shape``, padding included) in its dtype, and AdamW's
    two float32 moments of each."""
    from repro_torch.distributed import fsdp as FS
    from repro_torch.launch import steps as ST

    leaves, _ = ST.abstract_init(cfg)
    specs = ST.state_shardings(cfg, mesh, "adamw").params
    shapes = {k: tuple(t.shape) for k, t in leaves.items()}
    params = FS.shard_bytes(shapes, specs, mesh, {k: t.element_size() for k, t in leaves.items()})
    return params, 2 * FS.shard_bytes(shapes, specs, mesh, 4)


def shard_train(rank: int, mesh, dev, report: dict):
    """20a: qwen3-moe in bfloat16 at full width, 4 layers, every leaf and
    moment sharded on (2, 2), ``sorted_ep`` through the kernels, AdamW,
    5 steps of a global 4 x 512 batch.  Returns the state (20c saves it)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.kernels import grouped_matmul, ops
    from repro_torch.launch import roofline as RF
    from repro_torch.launch import steps as ST

    p = SHARD_TRAIN
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=p["layers"], mesh_axes=EP_AXES)
    step, init_state, opt = ST.make_train_step(cfg, lr=p["lr"], backend="cuda", mesh=mesh)
    if opt != "adamw" or not cfg.remat or cfg.moe.dispatch != "sorted_ep":
        raise SystemExit(f"FAIL sharded train: optimizer {opt}, remat {cfg.remat}, "
                         f"dispatch {cfg.moe.dispatch}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_state(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in state.params.parameters())
    moment_bytes = sum(t.numel() * t.element_size() for t in (*state.opt_m.values(),
                                                              *state.opt_v.values()))
    want = _at_rest(cfg, mesh)
    if (param_bytes, moment_bytes) != want:
        raise SystemExit(f"FAIL sharded train rank {rank}: bytes at rest "
                         f"{(param_bytes, moment_bytes)}, the specs' {want}")
    batch = ST.local_batch(train_batch(cfg, p["batch"], p["seq"], dev), mesh)
    flops_gmm = [0.0]

    def run():
        losses, norms, step_ms, st = [], [], [], state
        total, orig, tap = _shard_gmm_flops()  # over capture's tap, which stays
        grouped_matmul.grouped_matmul_launch = tap
        try:
            (st, met), flops = RF.count_flops(lambda: step(st, batch))
        finally:
            grouped_matmul.grouped_matmul_launch = orig
        flops_gmm[0] = total[0]
        first = dict(sharding.COLLECTIVES)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        for _ in range(p["steps"] - 1):
            t1 = time.perf_counter()
            st, met = step(st, batch)
            losses.append(float(met["loss"]))  # a sync: the step's end
            norms.append(float(met["grad_norm"]))
            step_ms.append((time.perf_counter() - t1) * 1e3)
        return (st, losses, norms, step_ms, flops, first), {}

    (state, losses, norms, step_ms, flops, first) = _mesh_part(
        report, "sharded train", rank, mesh.sub(EP_AXES),
        ("argsort", "grouped_matmul", "grouped_matmul_bwd"), run)
    info = report["sharded train"]
    launches = info["launches"]
    moe = cfg.n_layers * p["steps"]
    if launches["grouped_matmul_simt"] or launches["argsort"] != 2 * moe:
        raise SystemExit(f"FAIL sharded train rank {rank}: launches {launches} (argsort "
                         f"{2 * moe}, every bfloat16 product on the tensor cores)")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()) or not losses[-1] < losses[0]:
        raise SystemExit(f"FAIL sharded train rank {rank}: losses {losses}, norms {norms}")
    per_step = {k: (sharding.COLLECTIVES[k] - first[k]) / (p["steps"] - 1)
                for k in sharding.COLLECTIVES}
    coll = RF.collective_bytes_of(per_step)
    state_bytes = 2 * param_bytes + moment_bytes  # parameters, gradients, moments
    # the least HBM traffic of a step: the state read and written once by the
    # update, each gathered weight written once and read once where it is used
    hbm = 2 * state_bytes + 2 * per_step["all_gather_bytes"]
    roof = RF.from_measured(flops + flops_gmm[0], hbm, sum(coll.values()), 1,
                            coll_breakdown=coll)
    info.update(losses=losses, grad_norms=norms, step_ms=step_ms,
                ms_per_step_after_first=float(np.mean(step_ms)), init_s=init_s,
                param_bytes_at_rest=param_bytes, moment_bytes_at_rest=moment_bytes,
                spec_bytes_at_rest=list(want), collectives_per_step=per_step,
                flops_per_step=flops + flops_gmm[0], grouped_matmul_flops=flops_gmm[0],
                roofline=roof.as_dict(), roofline_lower_bound_ms=roof.step_time_lower_bound * 1e3,
                experts_held=int(state.params.layers[0].moe.wi.shape[0]),
                param_count=sum(int(np.prod(s)) for s in
                                (t.shape for t in ST.abstract_init(cfg)[0].values())))
    return state


def _one_process_step(cfg, dev, batch: dict, aux_weight: float, halves: int):
    """One process's train step (the kernels) from the seed's draw: its
    loss, gradient norm and the load-balance term of each of ``halves``
    data shards of the batch at the drawn weights (what ``sorted_ep``
    averages on that many data ranks), and the updated parameters and
    moments, left on the card: ``{"params/<name>" | "opt_m/<leaf>" |
    "opt_v/<leaf>": tensor}``."""
    import dataclasses

    import torch

    from repro_torch.distributed import moe_parallel as MP
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M

    plain = dataclasses.replace(cfg, mesh_axes=None)
    if plain.moe is not None:
        plain = dataclasses.replace(plain, moe=dataclasses.replace(plain.moe, dispatch="sorted"))
    MP.set_current_mesh(None)
    step, init_state, _ = ST.make_train_step(plain, lr=SHARD_GATE["lr"], backend="cuda",
                                             aux_weight=aux_weight)
    state = init_state(torch.Generator(device=dev).manual_seed(SEED))
    n = batch["tokens"].shape[0] // halves
    with torch.no_grad():
        aux = [float(M.forward(state.params, plain, batch["tokens"][i * n:(i + 1) * n])[2])
               for i in range(halves)]
    state, met = step(state, batch)
    ref = {f"params/{k}": t.detach() for k, t in state.params.named_parameters()}
    ref.update({f"opt_{f}/{k}": t for f in "mv" for k, t in getattr(state, f"opt_{f}").items()})
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                aux=float(np.mean(aux))), ref


def _mesh_step(cfg, mesh, dev, batch, rank: int, aux_weight: float):
    """One sharded step with the kernels from the seed's draw (rank 0's
    kernel inputs captured): its metrics, launches, and every leaf of the
    state as ``{"params/<name>" | "opt_m/<leaf>" | "opt_v/<leaf>": (shard,
    spec, global shape)}``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST

    step, init_state, _ = ST.make_train_step(cfg, lr=SHARD_GATE["lr"], backend="cuda",
                                             mesh=mesh, aux_weight=aux_weight)
    state = init_state(torch.Generator(device=dev).manual_seed(SEED))
    ops.reset_launch_counts()
    with capture("sharded fp32 gate") if rank == 0 else contextlib.nullcontext():
        state, met = step(state, ST.local_batch(batch, mesh))
    layout = state.params.layout
    leaves = {f"params/{n}": (t.detach(), layout.specs[n], layout.shapes[n])
              for n, t in state.params.named_parameters()}
    for key, place in ST.moment_placements(cfg, mesh, "adamw").items():
        f, k = key.split("/", 1)
        leaves[key] = (getattr(state, f)[k], place.spec, place.shape)
    metrics = {k: float(met[k]) for k in ("loss", "grad_norm", "aux")}
    return metrics, dict(ops.LAUNCHES), leaves


def rank0_card_buffer(rank: int, elems: int, dev):
    """A float32 buffer of ``elems`` on the card, rank 0's, that every rank
    maps (the ranks share the card): rank 0 broadcasts its CUDA IPC handle
    (``torch.multiprocessing``'s pickling) once.  CUDA IPC counts one
    receiver a send, so rank 0 never gets the buffer back: it is made once
    and refilled."""
    import torch
    from torch.multiprocessing.reductions import reduce_tensor

    buf = torch.empty(elems, dtype=torch.float32, device=dev) if rank == 0 else None
    box = [None if buf is None else reduce_tensor(buf)]
    torch.distributed.broadcast_object_list(box, src=0)
    if buf is None:
        rebuild, args = box[0]
        buf = rebuild(*args)
    return buf


SHARE_ELEMS = 1 << 30  # 20b: rank 0's float32 buffer (4 GiB) that the other ranks map


def gate_against_rank0(leaves: dict, ref, buf, mesh, whole) -> tuple[dict, dict, dict]:
    """20b's comparison of every rank's ``leaves`` with rank 0's whole
    leaves ``ref`` (None on the other ranks), which reach the ranks through
    ``buf`` (:func:`rank0_card_buffer`): rank 0 fills it with a group of
    leaves, every rank compares its shards of them, and so on.  Returns the shares of the bound (:func:`gate_shares`) of the leaves, of
    an unchanged state's moments (zero), and of the moments of
    ``GATE_MUTANT`` that twice its gradient gives."""
    import torch

    from repro_torch.distributed import sharding

    plan = None
    if ref is not None:
        plan, group, at = [], [], 0
        for key, t in ref.items():
            if t.numel() > buf.numel():
                raise SystemExit(f"FAIL sharded fp32 gate: {key} outgrows the shared buffer")
            if at + t.numel() > buf.numel():
                plan, group, at = plan + [group], [], 0
            group.append((key, at, tuple(t.shape)))
            at += t.numel()
        plan.append(group)
    box = [plan]
    torch.distributed.broadcast_object_list(box, src=0)
    shares, unchanged, doubled = {}, {}, {}
    mutants = {GATE_MUTANT.format(f) for f in "mv"}
    for group in box[0]:
        if ref is not None:
            for key, at, _ in group:
                buf[at:at + ref[key].numel()].copy_(ref[key].reshape(-1))
            torch.cuda.synchronize()
        sharding.barrier(whole)
        view = {key: buf[at:at + math.prod(shape)].view(shape) for key, at, shape in group}
        mine = {key: leaves[key] for key in view}
        shares.update(gate_shares(mine, view, mesh))
        unchanged.update(gate_shares({k: (torch.zeros_like(t), sp, shp) for k, (t, sp, shp)
                                      in mine.items() if not k.startswith("params")}, view, mesh))
        doubled.update(gate_shares({k: (t * (2.0 if k.startswith("opt_m") else 4.0), sp, shp)
                                    for k, (t, sp, shp) in mine.items() if k in mutants},
                                   view, mesh))
        del view
        sharding.barrier(whole)  # every rank has read the group
    return shares, unchanged, doubled


def gate_shares(leaves: dict, ref: dict, mesh, tol: float = 1e-3) -> dict:
    """For each leaf ``{key: (shard, spec, global shape)}``: the largest
    difference between this rank's shard and its block of the reference's
    whole leaf ``ref[key]``, as a share of the bound, ``tol`` times the
    reference leaf's largest magnitude (above 1: outside; NaN stays NaN)."""
    from repro_torch.distributed import sharding

    out = {}
    for key, (t, spec, shape) in leaves.items():
        whole = ref[key]
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        valid = sharding.valid_slices(shape, spec, mesh)
        want = sharding.shard_of(whole, spec, mesh)[valid].float()
        got = t[valid].to(want.device).float()
        scale = tol * max(float(whole.abs().max()), 1e-12)
        out[key] = float((got - want).abs().max()) / scale if got.numel() else 0.0
    return out


def _worst(shares: dict) -> dict:
    """The largest share of each kind of leaf (parameters, m, v)."""
    return {kind: max(v for k, v in shares.items() if k.startswith(kind))
            for kind in ("params", "opt_m", "opt_v")}


# a leaf replicated over "model": its cotangent counted once a rank would double it
GATE_MUTANT = "opt_{}/layers/ln1/scale"


def shard_gate(rank: int, meshes: dict, dev, report: dict) -> None:
    """20b: float32 at full width cut to 2 layers, one step from the seed's
    draw: qwen3-moe (``sorted_ep``, capacity factor E/k: no row drops) on
    (2, 2) and (1, 4), llama3-8b on (2, 2), each against one process (rank
    0, the kernels).  The mesh's loss within rtol 1e-5, its gradient norm
    within rtol 1e-4, and every rank's shard of every parameter and of both
    AdamW moments within 1e-3 of the one-process leaf's largest magnitude
    (the moments hold the clipped gradient: the first update, at the warmup's
    lr, is smaller than that bound).  On (2, 2) qwen3-moe runs without the
    load-balance term (``sorted_ep`` takes it per data shard, one process
    over the whole batch); its value is held to the mean of one process's
    over the two halves of the batch, and (1, 4) holds the term's gradient.
    The mesh step runs first and its state waits on the host; rank 0 then
    takes the one-process step and passes its leaves to the other ranks
    through a buffer on the card that they map (CUDA IPC).
    Two states that must fail the same bounds are checked to fail: the
    moments of an unchanged state (zero), and those that twice the gradient
    of one leaf, replicated over ``"model"``, gives.  Rank 0's kernel inputs
    are captured and held against the plain versions (``settle``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding

    g = SHARD_GATE
    whole = meshes[(2, 2)].sub(EP_AXES)
    base = get_config(TRAIN["arch"])
    moe = dataclasses.replace(base.moe, capacity_factor=base.moe.num_experts / base.moe.top_k)
    runs = {"qwen3-moe (2, 2)": (dataclasses.replace(base, moe=moe), (2, 2), 0.0),
            "qwen3-moe (1, 4)": (dataclasses.replace(base, moe=moe), (1, 4), 0.01),
            "llama3-8b (2, 2)": (get_config(SHARD_DENSE["arch"]), (2, 2), 0.01)}
    buf = None
    out = {}
    for name, (cfg, shape, aux_weight) in runs.items():
        cfg = dataclasses.replace(cfg, n_layers=g["layers"], dtype="float32", mesh_axes=EP_AXES)
        batch = train_batch(cfg, g["batch"], g["seq"], dev)
        mesh = meshes[shape]
        met, launches, leaves = _mesh_step(cfg, mesh, dev, batch, rank, aux_weight)
        res: dict = dict(metrics=met, launches=launches)
        if cfg.moe is not None:
            require_launches(f"sharded fp32 gate {name}", launches,
                             ("argsort", "grouped_matmul_simt", "grouped_matmul_bwd"))
        # the mesh's state waits on the host while rank 0 takes the one-process step
        leaves = {k: (t.cpu(), s, shp) for k, (t, s, shp) in leaves.items()}
        gc.collect()
        torch.cuda.empty_cache()
        sharding.barrier(whole)
        if buf is None:
            buf = rank0_card_buffer(rank, SHARE_ELEMS, dev)
        one, ref = (None, None)
        if rank == 0:
            one, ref = _one_process_step(cfg, dev, batch, aux_weight, shape[0])
        box = [one]
        torch.distributed.broadcast_object_list(box, src=0)
        one = box[0]
        shares, unchanged, doubled = gate_against_rank0(leaves, ref, buf, mesh, whole)
        res["worst_share_of_bound"] = _worst(shares)
        worst = max(shares, key=lambda k: -1.0 if shares[k] != shares[k] else shares[k])
        if not all(v <= 1.0 for v in shares.values()):
            raise SystemExit(f"FAIL sharded fp32 gate {name} rank {rank}: {worst} differs by "
                             f"{shares[worst]} of its bound (1e-3 of the leaf's magnitude)")
        res["unchanged_state_fails"] = sum(v > 1.0 for v in unchanged.values())
        res["doubled_gradient_share"] = max(doubled.values())
        if not res["unchanged_state_fails"] or not res["doubled_gradient_share"] > 1.0:
            raise SystemExit(f"FAIL sharded fp32 gate {name} rank {rank}: the bounds pass a "
                             f"wrong state ({res['unchanged_state_fails']} leaves of an "
                             f"unchanged one fail; a doubled gradient on {GATE_MUTANT} gives "
                             f"{res['doubled_gradient_share']} of its bound)")
        if rank == 0:
            res["one_process"] = one
            for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-4), ("aux", 1e-5)):
                if not np.isclose(met[key], one[key], rtol=rtol, atol=0):
                    raise SystemExit(f"FAIL sharded fp32 gate {name}: mesh {key} {met[key]}, "
                                     f"one process {one[key]} (rtol {rtol})")
        out[name] = res
        del leaves, ref
        gc.collect()
        torch.cuda.empty_cache()
        res["card_free_bytes_after"] = torch.cuda.mem_get_info()[0]
        sharding.barrier(whole)
        if rank == 0:
            log(f"phase 20b {name}: {json.dumps(res)}")
    report["sharded fp32 gate"] = out


def leaf_checksum(t, spec, mesh, shape):
    """This rank's part of an order-free checksum of a leaf: the sum, in
    wrapping int64, of each element's bits times a hash of its global
    index, over the rows its shard holds (one copy of each block counts).
    Summed over the ranks it is the leaf's, whatever mesh holds it."""
    import torch

    from repro_torch.distributed import sharding

    named = set(sharding.spec_axes(spec))
    if any(mesh.coords[a] for a in mesh.axis_names if a not in named):
        return torch.zeros((), dtype=torch.int64, device=t.device)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    valid = sharding.valid_slices(shape, spec, mesh)
    block = t[valid].contiguous()
    gidx = torch.zeros(block.shape, dtype=torch.int64, device=t.device)
    stride = 1
    for dim in reversed(range(len(shape))):
        blk = -(-int(shape[dim]) // sharding._ways(mesh, spec[dim]))
        lo = sharding._block(mesh, spec[dim]) * blk
        pos = torch.arange(block.shape[dim], device=t.device, dtype=torch.int64) + lo
        gidx += pos.view([-1 if i == dim else 1 for i in range(len(shape))]) * stride
        stride *= int(shape[dim])
    bits = block.view(torch.int16 if block.element_size() == 2 else torch.int32).to(torch.int64)
    return (bits * (gidx * 2654435761 + 97)).sum()


def _checksums(tree_specs: dict, mesh) -> "object":
    """The checksums of leaves ``{name: (tensor, spec, shape)}``, summed over
    ``mesh``'s ranks (one all-reduce)."""
    import torch

    from repro_torch.distributed import sharding

    parts = torch.stack([leaf_checksum(t, s, mesh, shp) for t, s, shp in tree_specs.values()])
    return sharding.all_reduce(mesh.sub(mesh.axis_names), parts, "sum").cpu().tolist()


EXPERT_LEAVES = ("layers/moe/wg", "layers/moe/wi", "layers/moe/wo")  # 20c: their layer 0's moments


def _restored_moments(cfg, mesh, state=None) -> tuple[dict, dict]:
    """20c's moments and their placements on ``mesh``: every AdamW moment
    leaf, the expert weights' cut to layer 0 (their other layers, 14.5 GB,
    would take ~40 s more through gloo); the moments are ``state``'s shards,
    or zeros of their shapes to restore into."""
    import torch

    from repro_torch.checkpoint.manager import Placement
    from repro_torch.distributed import sharding
    from repro_torch.launch import steps as ST

    placed, moments = {}, {}
    for key, p in ST.moment_placements(cfg, mesh, "adamw").items():
        f, k = key.split("/", 1)
        cut = k in EXPERT_LEAVES
        placed[key] = Placement(p.spec, (1, *p.shape[1:]) if cut else p.shape)
        if state is None:
            moments[key] = torch.zeros(sharding.shard_shape(placed[key].shape, p.spec, mesh),
                                       device=mesh.device)
        else:
            t = getattr(state, f)[k]
            moments[key] = t[:1] if cut else t
    return moments, placed


def shard_restore(rank: int, state, meshes: dict, dev, report: dict) -> None:
    """20c: 20a's parameters and AdamW moments (the expert weights' for
    layer 0) saved from (2, 2) (gathered on every rank, rank 0 writes the
    one-process format), then restored on (4, 1) and (1, 4): each rank's
    shards, checksummed over the mesh, equal the saved leaves bit for bit."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M

    src_mesh = meshes[(2, 2)]
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=SHARD_TRAIN["layers"],
                              mesh_axes=EP_AXES)
    root = ROOT / "build" / "shard_ckpt"
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    sharding.barrier(src_mesh.sub(EP_AXES))

    def sums(model, moments, mesh, placed):
        leaves = {f"params/{n}": (t.detach(), model.layout.specs[n], model.layout.shapes[n])
                  for n, t in model.named_parameters()}
        for key, t in moments.items():
            leaves[key] = (t, placed[key].spec, placed[key].shape)
        return _checksums(leaves, mesh)

    def tree(model, moments):
        return {"params": model, **{f: {k.split("/", 1)[1]: t for k, t in moments.items()
                                        if k.startswith(f + "/")} for f in ("opt_m", "opt_v")}}

    moments, placed = _restored_moments(cfg, src_mesh, state)
    want = sums(state.params, moments, src_mesh, placed)
    t0 = time.perf_counter()
    mgr = CheckpointManager(str(root))
    mgr.save(tree(state.params, moments), SHARD_TRAIN["steps"], mesh=src_mesh, specs=placed)
    sharding.barrier(src_mesh.sub(EP_AXES))
    save_s = time.perf_counter() - t0
    out = {"leaves": len(want), "save_s": save_s}
    if rank == 0:
        out["bytes_saved"] = (root / f"step_{SHARD_TRAIN['steps']:08d}" / "shard_p0.npz"
                              ).stat().st_size
    del moments
    for shape in ((4, 1), (1, 4)):
        mesh = meshes[shape]
        t0 = time.perf_counter()
        target = M.uninitialized(cfg, device=dev, mesh=mesh, sharded=True)
        zeros, p = _restored_moments(cfg, mesh)
        got, manifest = mgr.restore(tree(target, zeros), mesh=mesh, specs=p)
        restore_s = time.perf_counter() - t0
        moments = {f"{f}/{k}": t for f in ("opt_m", "opt_v") for k, t in got[f].items()}
        have = sums(got["params"], moments, mesh, p)
        if have != want or manifest["step"] != SHARD_TRAIN["steps"]:
            bad = [i for i, (a, b) in enumerate(zip(have, want)) if a != b]
            raise SystemExit(f"FAIL sharded restore {shape} rank {rank}: {len(bad)} leaves "
                             f"differ from the saved ones")
        out[str(shape)] = dict(restore_s=restore_s, experts_held=int(
            target.layers[0].moe.wi.shape[0]), param_bytes_at_rest=sum(
            t.numel() * t.element_size() for t in target.parameters()))
        del got, target, zeros, moments
        gc.collect()
        torch.cuda.empty_cache()
    sharding.barrier(src_mesh.sub(EP_AXES))
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    report["sharded restore"] = out


def shard_driver(rank: int, mesh, dev, report: dict) -> None:
    """20d: ``launch.train.train(..., mesh=)`` on (2, 2) with the qwen3-moe
    smoke config, 8 steps against 4 and a ``resume`` to 8: losses and the
    final checkpoint bit for bit."""
    import shutil

    from repro_torch.distributed import sharding
    from repro_torch.launch import train as TR

    d = SHARD_DRIVER
    root = ROOT / "build" / "shard_driver"
    if rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    sharding.barrier(mesh.sub(EP_AXES))
    kw = dict(smoke=True, batch=d["batch"], seq=d["seq"], log_every=1000, device=dev,
              mesh=mesh)
    t0 = time.perf_counter()
    full = TR.train(d["arch"], steps=d["steps"], ckpt_dir=str(root / "full"), **kw)
    first = TR.train(d["arch"], steps=d["cut"], ckpt_dir=str(root / "cut"), save_every=d["cut"],
                     **kw)
    rest = TR.train(d["arch"], steps=d["steps"], ckpt_dir=str(root / "cut"), resume=True,
                    save_every=1000, **kw)
    if first + rest != full:
        raise SystemExit(f"FAIL sharded driver rank {rank}: {first} + {rest} != {full}")
    info = dict(arch=d["arch"], mesh=list(mesh.shape.values()), steps=d["steps"], cut=d["cut"],
                losses=full, wall_s=time.perf_counter() - t0)
    if rank == 0:
        last = f"step_{d['steps']:08d}"
        with np.load(root / "full" / last / "shard_p0.npz") as a, \
                np.load(root / "cut" / last / "shard_p0.npz") as b:
            if sorted(a.files) != sorted(b.files) or not all(np.array_equal(a[k], b[k])
                                                             for k in a.files):
                raise SystemExit("FAIL sharded driver: the resumed run's checkpoint differs")
            info["checkpoint_leaves"] = len(a.files)
        shutil.rmtree(root, ignore_errors=True)
    report["sharded driver"] = info


def shard_path_rank(rank: int, meshes: dict, dev, report: dict) -> None:
    """Phase 20 on this rank: parts a-d, each rank's wall by part."""
    import torch

    from repro_torch.distributed import moe_parallel as MP

    walls = {}

    def done(part: str, t0: float, key: str) -> None:
        walls[part] = time.perf_counter() - t0
        if rank == 0:
            log(f"phase 20{part} rank 0, {walls[part]:.1f} s: {json.dumps(report[key])}")

    t0 = time.perf_counter()
    state = shard_train(rank, meshes[SHARD_TRAIN["mesh"]], dev, report)
    done("a", t0, "sharded train")
    t0 = time.perf_counter()
    shard_restore(rank, state, meshes, dev, report)
    done("c", t0, "sharded restore")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shard_gate(rank, meshes, dev, report)
    done("b", t0, "sharded fp32 gate")
    t0 = time.perf_counter()
    shard_driver(rank, meshes[(2, 2)], dev, report)
    done("d", t0, "sharded driver")
    MP.set_current_mesh(None)
    report["phase 20 wall_s"] = walls


def _shard_summary(reports: list[dict]) -> dict:
    """Phase 20's record from the ranks' reports."""
    _same_on_ranks("sharded train losses", [rep["sharded train"]["losses"] for rep in reports])
    keys = ("wall_s", "step_ms", "ms_per_step_after_first", "max_memory_allocated",
            "param_bytes_at_rest", "moment_bytes_at_rest", "spec_bytes_at_rest",
            "collectives_per_step", "launches", "host_syncs", "init_s", "experts_held",
            "flops_per_step", "grouped_matmul_flops", "roofline", "roofline_lower_bound_ms")
    a = reports[0]["sharded train"]
    return dict(
        a=dict(arch=TRAIN["arch"], layers=SHARD_TRAIN["layers"], dtype="bfloat16",
               mesh=list(SHARD_TRAIN["mesh"]), batch=SHARD_TRAIN["batch"],
               seq=SHARD_TRAIN["seq"], steps=SHARD_TRAIN["steps"], lr=SHARD_TRAIN["lr"],
               param_count=a["param_count"], losses=a["losses"], grad_norms=a["grad_norms"],
               ranks=[{k: rep["sharded train"][k] for k in keys} for rep in reports]),
        b=dict(rank0=reports[0]["sharded fp32 gate"],
               worst_share_of_bound=[{n: r["worst_share_of_bound"] for n, r in
                                      rep["sharded fp32 gate"].items()} for rep in reports]),
        c=[rep["sharded restore"] for rep in reports],
        d=reports[0]["sharded driver"],
        wall_s=[rep["phase 20 wall_s"] for rep in reports])


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
            **({"launches_simt": by_path[path]["grouped_matmul_simt"],
                "backward": BACKWARD_TIMES} if name == "grouped_matmul" else {}),
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
    check_grouped_matmul_backward(dev)

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
    stream_path(dev, rows, q18, main, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    service_path(dev, rows, by_path)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_path(dev, rows, q18, by_path)
    del rows, q18
    gc.collect()
    torch.cuda.empty_cache()
    for phase, fn in ((14, lambda: dedup_path(dev, by_path)), (15, lambda: dense_path(dev)),
                      (16, examples_path), (17, lambda: family_path(dev, by_path)),
                      (18, lambda: training_path(dev, by_path)),
                      (19, lambda: ep_path(by_path))):
        t0 = time.perf_counter()
        fn()
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
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

#!/usr/bin/env python3
"""Measure the port's per-row cost constants on a device and write them into
``src/repro_torch/core/_cost_constants.py`` (the port's twin of
``benchmarks/calibrate.py``).

Run from the repository root on a machine with an NVIDIA card:

    PYTHONPATH=src python3 scripts/calibrate_torch.py            # the "cuda" entry
    PYTHONPATH=src python3 scripts/calibrate_torch.py --check    # validate only
    PYTHONPATH=src python3 scripts/calibrate_torch.py --smoke --device cpu

It times the port's own primitives — one streamed absorb pass per
run-generation policy at two duplicate-rate anchors, the batch sort (the
argsort), the linear merge-absorb of two sorted M-row states, the hash
aggregation, and the spill write of a run slot — and writes an entry keyed
by the torch device type, keeping every other entry as it is.  On a card
every time is taken with CUDA events around work that starts on an idle
card; on the CPU with the host clock.  Each figure is the least of
``--iters`` timed runs after a warm-up run; ``meta.spread_ns`` keeps the
least and the most.

The configuration is the one the card's users run: ``chip_smoke.py``'s
``MAIN_CFG`` (M = 2^20, B = 2^16, P = 2^14, F = 16) over 16·M rows, staged
in chunks of M rows (an adaptive stream's staging unit; the reference
stages B-row chunks, which the read-sort-write policies would pad to M).
``meta.note`` records it with the card's name and power limit.  The hash
constant times ``core/hash_agg.py``, which runs on the host's NumPy for any
device: it is the host's figure, not the card's.

``--smoke`` runs the same code at tiny sizes and writes a temp file
(``--out`` names another); ``--check`` validates the committed file.
"""
from __future__ import annotations

import argparse
import pprint
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import cost_model, dispatch, hash_agg, pipeline, sorted_ops  # noqa: E402
from repro_torch.core.types import ExecConfig, keys_to_torch, resolve_device  # noqa: E402

CONSTANTS_PATH = ROOT / "src" / "repro_torch" / "core" / "_cost_constants.py"
MAIN_CFG = dict(memory_rows=1 << 20, batch_rows=1 << 16, page_rows=1 << 14, fanin=16)
SMOKE_CFG = dict(memory_rows=256, batch_rows=64, page_rows=32, fanin=4)

HEADER = '''"""Measured per-row costs of the engine's primitives, keyed by torch device
type.

AUTOGENERATED by ``scripts/calibrate_torch.py`` — do not edit by hand;
run the calibration again on new hardware instead.  The ``cpu`` entry is
the JAX package's committed one (``benchmarks/calibrate.py`` on a CPU,
through its XLA backend); the ``cuda`` entry was measured on an NVIDIA
H100 by ``scripts/calibrate_torch.py`` (its ``meta`` names the card, the
power limit and the configuration).  Every device without an entry uses
the ``cpu`` one.

All figures are nanoseconds per input row.  ``absorb_row_ns`` is the
per-row cost of one absorb step under each run-generation policy
(including the batch sort that policy pays); ``sort_row_ns`` is that
batch sort alone, so a caller with pre-sorted input can subtract it
(:func:`repro_torch.core.cost_model.policy_cost_per_row`).
"""
'''


class Clock:
    """Seconds of work on ``device``: CUDA events on a card (the work starts
    on an idle card), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3


def _time(clock: Clock, fn, iters: int, rows: int) -> tuple[float, float]:
    """(least, most) ns a row over ``iters`` runs after a warm-up run."""
    clock(fn)
    ns = [clock(fn) / rows * 1e9 for _ in range(iters)]
    return min(ns), max(ns)


def _bench_absorb(policy, cfg, n_rows, dev, clock, iters, *, dup: bool):
    """The streamed absorb loop under ``policy`` at one of the two
    duplicate-rate anchors the cost model interpolates between: keys over
    a huge domain (d ≈ 0) or a tiny one (d ≈ 1)."""
    rng = np.random.default_rng(7)
    hi = 128 if dup else 2**31
    keys = rng.integers(1, hi, size=n_rows).astype(np.uint32)
    vals = rng.random((n_rows, 1)).astype(np.float32)
    M = cfg.memory_rows
    chunks = [(keys[i:i + M], vals[i:i + M]) for i in range(0, n_rows, M)]

    def run():
        agg = pipeline.StreamingAggregator(cfg, policy=policy, key_dtype=np.uint32, width=1,
                                           device=dev)
        staged = None
        for k, p in chunks:
            nxt = agg.stage(k, p)
            agg.absorb_staged(staged)
            staged = nxt
        agg.absorb_staged(staged)

    return _time(clock, run, iters, n_rows)


def _bench_sort(m, dev, clock, iters):
    """The batch sort a read-sort-write policy pays per memory load: the
    backend's argsort of M keys."""
    rng = np.random.default_rng(11)
    keys = keys_to_torch(rng.integers(1, 2**31, size=m).astype(np.uint32), dev)
    argsort = dispatch.get_backend("auto", dev).argsort
    return _time(clock, lambda: argsort(keys), iters, m)


def _bench_merge(m, dev, clock, iters):
    """One linear merge-absorb of two sorted M-row states, a row of the
    2M: the unit of every pre-merge level and of the ordered-index absorb."""
    rng = np.random.default_rng(13)
    ka = np.sort(rng.choice(2**30, size=m, replace=False)).astype(np.uint32)
    kb = (np.sort(rng.choice(2**30, size=m, replace=False)) + 2**30).astype(np.uint32)
    a = sorted_ops.sorted_groupby(keys_to_torch(ka, dev), key_dtype=np.uint32)
    b = sorted_ops.sorted_groupby(keys_to_torch(kb, dev), key_dtype=np.uint32)
    return _time(clock, lambda: sorted_ops.merge_absorb(a, b, assume_unique=True), iters, 2 * m)


def _bench_hash(n, cfg, dev, clock, iters):
    """The in-memory hash aggregation baseline (build + probe); the port's
    runs on the host's NumPy."""
    rng = np.random.default_rng(17)
    keys = rng.integers(1, cfg.memory_rows // 2, size=n).astype(np.uint32)
    return _time(clock, lambda: hash_agg.hash_aggregate(keys, None, cfg, device=dev), iters, n)


def _bench_spill_write(m, slots, dev, clock, iters):
    """Writing a sorted run of M rows into one slot of the run store (the
    engine's ``_write_slot``: keys, counts and a sum plane)."""
    rng = np.random.default_rng(19)
    store = pipeline._stacked_empty(slots, m, 1, key_dtype=np.uint32, widths=(1, 0, 0),
                                    device=dev)
    run = sorted_ops.sorted_groupby(
        keys_to_torch(rng.integers(1, 2**31, size=m).astype(np.uint32), dev),
        torch.ones((m, 1), device=dev), key_dtype=np.uint32, widths=(1, 0, 0))
    return _time(clock, lambda: pipeline._write_slot(store, 1, 0, run), iters, m)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def calibrate(args) -> dict:
    dev = resolve_device(args.device)
    clock = Clock(dev)
    cfg = ExecConfig(**(SMOKE_CFG if args.smoke else MAIN_CFG))
    M = cfg.memory_rows
    n_rows, iters = (8 * M, 1) if args.smoke else (16 * M, args.iters)
    spread: dict[str, list[float]] = {}

    def keep(name, lo_hi):
        spread[name] = [round(lo_hi[0], 3), round(lo_hi[1], 3)]
        return round(lo_hi[0], 3)

    absorb, absorb_dup = {}, {}
    for policy in pipeline.POLICIES:
        absorb[policy] = keep(f"absorb_row_ns.{policy}", _bench_absorb(
            policy, cfg, n_rows, dev, clock, iters, dup=False))
        absorb_dup[policy] = keep(f"absorb_dup_row_ns.{policy}", _bench_absorb(
            policy, cfg, n_rows, dev, clock, iters, dup=True))
        print(f"absorb[{policy:12s}] {absorb[policy]:10.3f} ns/row uniq  "
              f"{absorb_dup[policy]:10.3f} ns/row dup", flush=True)
    sort_ns = keep("sort_row_ns", _bench_sort(M, dev, clock, max(3, iters)))
    merge_ns = keep("merge_row_ns", _bench_merge(M, dev, clock, max(3, iters)))
    hash_ns = keep("hash_probe_row_ns", _bench_hash(n_rows, cfg, dev, clock, max(2, iters)))
    spill_ns = keep("spill_write_row_ns", _bench_spill_write(M, 16, dev, clock, max(3, iters)))
    for name, v in (("sort", sort_ns), ("merge", merge_ns), ("hash probe", hash_ns),
                    ("spill write", spill_ns)):
        print(f"{name:20s}{v:10.3f} ns/row", flush=True)
    card = card_line() if dev.type == "cuda" else "the host's CPU"
    return {
        "schema_version": cost_model.COST_SCHEMA_VERSION,
        "absorb_row_ns": absorb,
        "absorb_dup_row_ns": absorb_dup,
        "sort_row_ns": sort_ns,
        "merge_row_ns": merge_ns,
        "hash_probe_row_ns": hash_ns,
        "spill_write_row_ns": spill_ns,
        "meta": {
            "generated_by": "scripts/calibrate_torch.py",
            "backend": dev.type,
            "dispatch_backend": dispatch.resolve_backend_name("auto", dev),
            "smoke": bool(args.smoke),
            "device": card,
            "note": (f"memory_rows={M} batch_rows={cfg.batch_rows} page_rows={cfg.page_rows} "
                     f"fanin={cfg.fanin} n_rows={n_rows} chunk_rows={M} iters={iters}; "
                     f"{card}; least of the iterations (spread_ns: least, most); "
                     "hash_probe_row_ns times the host's NumPy hash aggregation, which "
                     "core/hash_agg.py runs for every device"),
            "spread_ns": spread,
        },
    }


def render(table: dict) -> str:
    body = pprint.pformat(table, width=76, sort_dicts=True)
    return (f"{HEADER}\nCOST_SCHEMA_VERSION = {cost_model.COST_SCHEMA_VERSION}\n\n"
            f"COST_CONSTANTS = {body}\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--smoke", action="store_true",
                   help="tiny sizes; write a temp file unless --out names one")
    p.add_argument("--out", default=None,
                   help="write the constants module here (default: the committed one)")
    p.add_argument("--check", action="store_true",
                   help="only validate the committed constants, then exit")
    args = p.parse_args(argv)

    from repro_torch.core import _cost_constants as cc

    if args.check:
        cost_model.validate_constants(cc.COST_CONSTANTS)
        if cc.COST_SCHEMA_VERSION != cost_model.COST_SCHEMA_VERSION:
            raise SystemExit(f"module COST_SCHEMA_VERSION={cc.COST_SCHEMA_VERSION} != "
                             f"generator {cost_model.COST_SCHEMA_VERSION}")
        print(f"{CONSTANTS_PATH.relative_to(ROOT)} OK (schema v{cc.COST_SCHEMA_VERSION}, "
              f"backends: {sorted(cc.COST_CONSTANTS)})")
        return 0

    entry = calibrate(args)
    table = dict(cc.COST_CONSTANTS)  # the other devices' entries stay
    table[entry["meta"]["backend"]] = entry
    cost_model.validate_constants(table, source="<regenerated>")
    out = args.out
    if out is None:
        out = (tempfile.mkstemp(suffix="_cost_constants.py")[1] if args.smoke
               else str(CONSTANTS_PATH))
    src = render(table)
    ns: dict = {}
    exec(compile(src, out, "exec"), ns)  # the module must parse and validate
    cost_model.validate_constants(ns["COST_CONSTANTS"], source=out)
    Path(out).write_text(src)
    print(f"wrote {out}")
    d_star = cost_model.crossover_dup_rate(constants=entry, merge_levels=1)
    print(f"fitted traditional <-> early_agg crossover duplicate rate: {d_star:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

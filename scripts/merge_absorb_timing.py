#!/usr/bin/env python3
"""Time one kernel of the SF-10 aggregate path (``--kernel``: the
merge-path merge-absorb, the argsort or the segmented combine), or the
bitonic foil on that path's merge-absorb inputs (``bitonic``), of one
source tree on one CUDA card by each yardstick ``chip_smoke.py`` has used,
so that two trees (this checkout and an earlier commit unpacked beside
it) compare on the same footing.  Run from the repository root:

    python3 scripts/merge_absorb_timing.py [--kernel K] [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's); the data and the timers are this checkout's
``chip_smoke.py``.  The script aggregates TPC-H ``lineitem`` at SF 10 by
``l_orderkey`` as ``chip_smoke.py``'s phase 3 does, checks it against the
NumPy oracle, and measures:

* ``wall_s``: one aggregate, warm, as it is;
* ``path_device_ms``: the kernel's calls of one more aggregate, each
  enqueued while the card slept so that CUDA events around it time the
  card's work alone, summed (``calls`` of them);
* on the first inputs of each shape the path gave the kernel (``calls``
  of that shape; for the argsort also the serve path's 32 and 8,192 keys,
  seeded expert ids; for the combine also seeded states of the shapes the
  join and pipeline paths give it: 65,536 rows with a 4-wide sum plane,
  8,388,608 rows with a 1- and a 3-wide one), three times each:
  ``device_ms`` (``chip_smoke.cuda_ms``: CUDA events around 20 calls the
  host enqueued while the card slept), ``back_to_back_ms`` (CUDA events
  around 20 calls enqueued back to back, the yardstick before
  ``cuda_ms``: the larger of the host's and the card's time), ``host_ms``
  (the host's time a call), and the kernels and memsets one call puts on
  the card (``torch.profiler``); for the argsort ``torch.argsort``'s
  device ms beside.

For ``bitonic`` the path's calls are the merge-absorb's (the foil is on
no user's path): each shape the path gave the merge-absorb is replayed
through the foil, ``path_device_ms`` is the sum over shapes of calls x
the shape's least ``device_ms``, and each shape also times the segmented
combine of the merged rows alone (``combine_of_merged_device_ms``: what a
foil that merged first and combined after would pay on top of its merge).

Prints one JSON line; exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SLEEP_MS = 1.0  # longer than the host takes to enqueue one call


def back_to_back_ms(fn, reps: int) -> float:
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


def kernels(src_mods):
    """kernel -> (module, launch function, plain function, signature of a
    call, copy of a call's inputs)."""
    import torch

    bitonic_sort, merge_path, segmented_reduce, merge_aggregate = src_mods

    def copy(st):
        return st.map(torch.clone)

    return {
        "merge_absorb": (merge_path, "merge_absorb_cuda", "merge_absorb_plain",
                         lambda a, b, **kw: (a.capacity, b.capacity, a.widths,
                                             kw.get("assume_unique", False)),
                         lambda a, b, **kw: ((copy(a), copy(b)), kw)),
        "argsort": (bitonic_sort, "argsort_cuda", "argsort_plain",
                    lambda k: (k.shape[0],), lambda k: ((k.clone(),), {})),
        "segmented_combine": (segmented_reduce, "segmented_combine_cuda",
                              "segmented_combine_plain", lambda st: (st.capacity, st.widths),
                              lambda st: ((copy(st),), {})),
        # the signature and copy are of the merge-absorb's calls, which it replays
        "bitonic": (merge_aggregate, "merge_absorb_bitonic_cuda", "merge_absorb_bitonic_plain",
                    lambda a, b, **kw: (a.capacity, b.capacity, a.widths),
                    lambda a, b, **kw: ((copy(a), copy(b)), {})),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel",
                    choices=("merge_absorb", "argsort", "segmented_combine", "bitonic"),
                    default="merge_absorb")
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    src = args.src.resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("merge_absorb_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core.ordered_index import argsort_torch
    from repro_torch.core.types import concat_states, take
    from repro_torch.kernels import (
        _build,
        bitonic_sort,
        merge_aggregate,
        merge_path,
        ops,
        segmented_reduce,
    )

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, not {src}")
    dev = torch.device("cuda", 0)
    mod, launch, plain, sig, snap = kernels(
        (bitonic_sort, merge_path, segmented_reduce, merge_aggregate))[args.kernel]
    foil = args.kernel == "bitonic"
    # the path's function whose calls are timed (the foil: captured only)
    path_mod, path_launch = (merge_path, "merge_absorb_cuda") if foil else (mod, launch)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0

    rows, ordered = cs.lineitem(10, np.random.default_rng(cs.SEED), part_supp=False)
    cfg = repro_torch.ExecConfig(**cs.MAIN_CFG)

    def aggregate():
        res = repro_torch.aggregate(
            {"orderkey": rows["orderkey"]}, by=repro_torch.KeySpec.of(orderkey=26),
            values=rows["quantity"], aggs=("count", "sum"), cfg=cfg, device=dev)
        torch.cuda.synchronize()
        return res

    aggregate()
    t0 = time.perf_counter()
    res = aggregate()
    wall_s = time.perf_counter() - t0
    rel = res.relation()
    uk, cnt, sums = cs.oracle(ordered["orderkey"], ordered["quantity"])
    cs.check_equal("Q18 keys", rel["orderkey"], uk)
    cs.check_equal("Q18 counts", rel["count"], cnt)
    cs.check_equal("Q18 sums", rel["sum"][:, 0].astype(np.float64), sums)

    inner, per_call, shapes = getattr(mod, launch), [], {}
    path_inner = getattr(path_mod, path_launch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def note(*a, **kw):
        key = sig(*a, **kw)
        if key not in shapes:
            shapes[key] = [0, snap(*a, **kw)]
        shapes[key][0] += 1

    def captured(*a, **kw):
        note(*a, **kw)
        return path_inner(*a, **kw)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        cs._device_sleep(SLEEP_MS)
        start.record()
        out = inner(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end))
        note(*a, **kw)
        return out

    ops.reset_launch_counts()
    setattr(path_mod, path_launch, captured if foil else timed)
    try:
        aggregate()
    finally:
        setattr(path_mod, path_launch, path_inner)
    if foil:
        if sum(c for c, _ in shapes.values()) != ops.LAUNCHES["merge_absorb"]:
            raise SystemExit("captured fewer merge-absorb calls than the path launched")
    elif len(per_call) != ops.LAUNCHES[args.kernel]:
        raise SystemExit(f"timed {len(per_call)} calls of {ops.LAUNCHES[args.kernel]}")
    rng = np.random.default_rng(cs.SEED)
    if args.kernel == "argsort":  # the serve path's decode and prefill: expert ids
        for n in (32, 8192):
            keys = torch.from_numpy(rng.integers(0, 128, n)).to(dev)
            shapes[(n,)] = [0, ((keys,), {})]
    if args.kernel == "segmented_combine":  # the join_aggregate's and the pipeline's
        for n, widths in ((65536, (4, 0, 0)), (8388608, (1, 0, 0)), (8388608, (3, 0, 0))):
            st = cs.make_state(rng, n, np.uint32, n // 4, 0.0, widths, device=dev)
            shapes[(n, widths)] = [0, ((st,), {})]

    def same(key, got, want) -> None:
        if args.kernel == "argsort":
            if not torch.equal(got, want):
                raise SystemExit(f"argsort {key}: differs from the plain version")
        else:
            cs.state_diff(f"{args.kernel} {key}", got, want)

    by_shape = []
    for key, (calls, (a, kw)) in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        def call(a=a, kw=kw):
            return inner(*a, **kw)

        same(key, call(), getattr(mod, plain)(*a, **kw))
        timings = []
        for _ in range(3):
            device_ms, host_ms = cs.cuda_ms(call, args.reps)
            timings.append(dict(device_ms=device_ms, host_ms=host_ms,
                                back_to_back_ms=back_to_back_ms(call, args.reps)))
        prof = cs.device_profile(f"{key}", lambda: [call() for _ in range(args.reps)], {})
        entry = dict(
            shape=[list(x) if isinstance(x, tuple) else x for x in key], calls=calls,
            timings=timings, profiled_device_ms=prof.get("device_busy_ms", 0) / args.reps,
            on_card_per_call=[[name, ms / args.reps, count / args.reps]
                              for name, ms, count in prof.get("top_kernels", [])])
        if args.kernel == "argsort":
            entry["torch_argsort_device_ms"] = cs.cuda_ms(
                lambda: torch.argsort(a[0], stable=True), args.reps)[0]
        if foil:
            merged = concat_states(*a)
            merged = take(merged, argsort_torch(merged.keys))
            if hasattr(merge_aggregate, "plan"):  # trees before the packed-word network: none
                entry["m"], _, entry["passes"] = merge_aggregate.plan(key[0], key[1])
            entry["combine_of_merged_device_ms"] = cs.cuda_ms(
                lambda: segmented_reduce.segmented_combine_cuda(merged), args.reps)[0]
        by_shape.append(entry)
    if foil:
        calls = sum(e["calls"] for e in by_shape)
        path_ms = sum(e["calls"] * min(t["device_ms"] for t in e["timings"]) for e in by_shape)
    else:
        calls, path_ms = len(per_call), sum(per_call)
    print(json.dumps(dict(
        kernel=args.kernel, src=str(src), card=cs.card_line(), build_s=build_s, wall_s=wall_s,
        calls=calls, path_device_ms=path_ms, by_shape=by_shape)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

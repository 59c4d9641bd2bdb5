#!/usr/bin/env python3
"""Time the merge-path merge-absorb (``ops.merge_absorb_sorted``) of one
source tree on one CUDA card by each yardstick ``chip_smoke.py`` has used,
so that two trees (this checkout and an earlier commit unpacked beside
it) compare on the same footing.  Run from the repository root:

    python3 scripts/merge_absorb_timing.py [--src DIR]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's); the data and the timers are this checkout's
``chip_smoke.py``.  The script aggregates TPC-H ``lineitem`` at SF 10 by
``l_orderkey`` as ``chip_smoke.py``'s phase 3 does, checks it against the
NumPy oracle, and measures:

* ``wall_s``: one aggregate, warm, as it is;
* ``path_device_ms``: the merge-absorb calls of one more aggregate, each
  enqueued while the card slept so that CUDA events around it time the
  card's work alone, summed (``calls`` of them);
* on the first inputs of each shape the path gave the kernel (``calls``
  of that shape), three times each:
  ``device_ms`` (``chip_smoke.cuda_ms``: CUDA events around 20 calls the
  host enqueued while the card slept), ``back_to_back_ms`` (CUDA events
  around 20 calls enqueued back to back, the yardstick before
  ``cuda_ms``: the larger of the host's and the card's time), ``host_ms``
  (the host's time a call), and the kernels and memsets one call puts on
  the card (``torch.profiler``).

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    from repro_torch.kernels import _build, merge_path, ops

    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, not {src}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.lib("merge_path")
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

    inner, per_call, shapes = merge_path.merge_absorb_cuda, [], {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(a, b, **kw):
        torch.cuda.synchronize()
        cs._device_sleep(SLEEP_MS)
        start.record()
        out = inner(a, b, **kw)
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end))
        key = (a.capacity, b.capacity, a.widths, kw.get("assume_unique", False))
        if key not in shapes:
            shapes[key] = [0, a.map(torch.clone), b.map(torch.clone), kw]
        shapes[key][0] += 1
        return out

    ops.reset_launch_counts()
    merge_path.merge_absorb_cuda = timed
    try:
        aggregate()
    finally:
        merge_path.merge_absorb_cuda = inner
    if len(per_call) != ops.LAUNCHES["merge_absorb"]:
        raise SystemExit(f"timed {len(per_call)} calls of {ops.LAUNCHES['merge_absorb']}")

    by_shape = []
    for (na, nb, widths, unique), (calls, a, b, kw) in sorted(shapes.items(), key=str):
        def call(a=a, b=b, kw=kw):
            return inner(a, b, **kw)

        cs.state_diff(f"{na}+{nb}", call(), merge_path.merge_absorb_plain(a, b, **kw))
        timings = []
        for _ in range(3):
            device_ms, host_ms = cs.cuda_ms(call, args.reps)
            timings.append(dict(device_ms=device_ms, host_ms=host_ms,
                                back_to_back_ms=back_to_back_ms(call, args.reps)))
        prof = cs.device_profile(f"{na}+{nb}", lambda: [call() for _ in range(args.reps)], {})
        by_shape.append(dict(
            shape=[na, nb, list(widths), unique], calls=calls, timings=timings,
            profiled_device_ms=prof.get("device_busy_ms", 0) / args.reps,
            on_card_per_call=[[name, ms / args.reps, count / args.reps]
                              for name, ms, count in prof.get("top_kernels", [])]))
    print(json.dumps(dict(
        src=str(src), card=cs.card_line(), build_s=build_s, wall_s=wall_s,
        calls=len(per_call), path_device_ms=sum(per_call), by_shape=by_shape)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

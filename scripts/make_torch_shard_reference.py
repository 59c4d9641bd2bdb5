#!/usr/bin/env python3
"""Compute the JAX package's results for the mesh cases of
``tests/test_torch_shard.py`` (``tests/_torch_shard_cases.py``'s ``CASES``,
run by its ``reference(name)``) and store them in
``tests/data/torch_shard_reference.npz``, which that module holds the port's
ranks against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_shard_reference.py

The reference's mesh programs need several devices: the script runs itself
again in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(the cases' worlds are 1, 2 and 4).  Three things are lent to the reference
for the run, without editing it: ``jax.experimental.enable_x64`` (its uint64
scope's old name), ``shard_map``'s replication check off
(``repro.distributed._compat._CHECK_DEFAULT = False``, the behaviour it was
written for: the installed JAX's ``check_vma`` rejects the reference's mesh
pipeline, "cond branches must have equal output types"), and every
``shard_map`` it builds wrapped in ``jax.jit`` (its mesh merge join calls
one eagerly, which the installed JAX refuses with "Unexpected XLA sharding
override").

``--check`` recomputes every case and compares it with the stored file
instead of writing it (exit 1 on any difference).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEVICES = 4
FLAG = f"--xla_force_host_platform_device_count={DEVICES}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the stored file instead of writing it")
    args = ap.parse_args()
    if FLAG not in os.environ.get("XLA_FLAGS", ""):
        env = dict(os.environ, XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FLAG}".strip(),
                   JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
        return subprocess.run([sys.executable, __file__, *sys.argv[1:]], env=env).returncode
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import jax
    import jax.experimental

    import repro.distributed._compat as compat

    if not hasattr(jax.experimental, "enable_x64"):  # the reference's old name
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    compat._CHECK_DEFAULT = False
    eager = compat.shard_map
    compat.shard_map = lambda f, **kw: jax.jit(eager(f, **kw))
    import _torch_shard_cases as cases

    path = ROOT / "tests" / "data" / "torch_shard_reference.npz"
    out: dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    for name in cases.CASES:
        out.update(cases.to_arrays(name, cases.reference(name)))
        jax.clear_caches()
        print(f"[{time.perf_counter() - t0:7.1f} s] {name}", flush=True)
    if not args.check:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, **out)
        print(f"wrote {len(cases.CASES)} cases to {path.relative_to(ROOT)}")
        return 0
    stored = np.load(path)
    bad = sorted(set(stored.files) ^ set(out))
    bad += [k for k in out if k in stored.files and not (
        out[k].dtype == stored[k].dtype and np.array_equal(out[k], stored[k])
        if out[k].dtype.kind != "U" else str(out[k]) == str(stored[k]))]
    for k in bad:
        print(f"differs: {k}")
    print(f"{len(cases.CASES)} cases, {len(out)} arrays, {len(bad)} differences")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""Write or check the JAX package's stored results for a port test module.

The module (under ``tests/``) names its cases in ``STORED_CASES``, computes
the reference's arrays of one case with ``compute(name)`` (entry -> NumPy
array) and names its file in ``REFERENCE_FILE``.  ``main`` writes every
case's arrays there as ``"<case>|<entry>"``, or with ``--check`` recomputes
them (or only the ``--case`` named) and compares with the stored file,
dtypes and values bit for bit (exit 1 on any difference).
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main(module: str, description: str) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):  # the reference's old name
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)
    ap = argparse.ArgumentParser(description=description.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the stored file instead of writing it")
    ap.add_argument("--case", action="append",
                    help="with --check: recompute and compare only this case (repeatable)")
    args = ap.parse_args()
    mod = importlib.import_module(module)
    names = mod.STORED_CASES
    if args.case:
        if not args.check or set(args.case) - set(names):
            ap.error(f"--case takes --check and cases of {names}")
        names = tuple(args.case)
    out: dict[str, np.ndarray] = {}
    t0 = time.perf_counter()
    for name in names:
        out.update({f"{name}|{k}": np.asarray(v) for k, v in mod.compute(name).items()})
        jax.clear_caches()  # one process compiles every case's programs
        print(f"[{time.perf_counter() - t0:7.1f} s] {name}", flush=True)
    path = mod.REFERENCE_FILE
    if not args.check:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, **out)
        print(f"wrote {len(mod.STORED_CASES)} cases to {path.relative_to(ROOT)}")
        return 0
    stored = np.load(path)
    files = [k for k in stored.files if k.split("|")[0] in names]
    bad = sorted(set(files) ^ set(out))
    bad += [k for k in out if k in stored.files and not (
        out[k].dtype == stored[k].dtype and np.array_equal(out[k], stored[k]))]
    for k in bad:
        print(f"differs: {k}")
    print(f"{len(names)} cases, {len(out)} arrays, {len(bad)} differences")
    return 1 if bad else 0

#!/usr/bin/env python3
"""Compute the JAX package's results for the cases of
``tests/test_torch_ep.py`` (``tests/_torch_ep_cases.py``'s
``STORED_CASES``: the expert-parallel MoE block with its gradients on
meshes (2, 4), (1, 4), (2, 2) and (2, 2, 2), and at capacity factor 1; the
smoke model's prefill and decode with ``sorted_ep`` on (2, 2); the ring
all-gather matmul on 4 and 8 devices; the GPipe pipeline and its
gradients) and store them in ``tests/data/torch_ep_reference.npz``, which
that module holds the port's ranks against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_ep_reference.py

The reference's mesh programs need several devices: the script runs itself
again in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``.
Each case lends the reference ``shard_map``'s replication check off
(``repro.distributed._compat._CHECK_DEFAULT = False``, the behaviour its
mesh paths were written for: the installed JAX's ``check_vma`` rejects the
EP block and the ring, "out_specs which require replication which can't be
statically inferred") and runs its programs under ``jax.jit``.

``--check`` recomputes every case (``--case NAME``: that one) and compares
it with the stored file instead of writing it (exit 1 on any difference,
bit for bit).
"""
import os
import subprocess
import sys
from pathlib import Path

from _stored_reference import main

FLAG = "--xla_force_host_platform_device_count=8"

if __name__ == "__main__":
    if FLAG not in os.environ.get("XLA_FLAGS", ""):
        env = dict(os.environ, XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {FLAG}".strip(),
                   JAX_PLATFORMS="cpu")
        sys.exit(subprocess.run([sys.executable, __file__, *sys.argv[1:]], env=env).returncode)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.exit(main("_torch_ep_cases", __doc__))

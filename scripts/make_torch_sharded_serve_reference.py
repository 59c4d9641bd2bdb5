#!/usr/bin/env python3
"""Compute the JAX package's results for the cases of
``tests/test_torch_sharded_serve.py`` (``tests/_torch_sharded_serve_cases.py``'s
``STORED_CASES``: the sharded prefill and two decode steps of eight smoke
cases on a data x model mesh (2, 4), one of them a batch of 3 that every
rank holds whole: the logits, every device's shard of
every cache leaf, and the caches' index) and store them in
``tests/data/torch_sharded_serve_reference.npz``, which that module holds
the port against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_sharded_serve_reference.py

The reference's mesh programs need several devices: the script runs itself
again in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``.
Its meshes are built with ``Auto`` axes (on the installed JAX's default,
``Explicit``, the reference's ``sorted_ep`` serve fails its first decode
step), and the expert-parallel block runs with ``shard_map``'s replication
check off, as its mesh paths were written.

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
    sys.exit(main("_torch_sharded_serve_cases", __doc__))

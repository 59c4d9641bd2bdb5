#!/usr/bin/env python3
"""Compute the JAX package's results for the cases of
``tests/test_torch_sharding.py`` (``tests/_torch_sharding_cases.py``'s
``STORED_CASES``: every architecture's logical spec tree, state and batch
specs, shard shapes and cache specs on the meshes (2, 4), (16, 16) and
(2, 16, 16); the qwen3-moe smoke model's addressable shards on (2, 4); two
sharded train steps of three smoke configs on (2, 4)) and store them in
``tests/data/torch_sharding_reference.npz``, which that module holds the
port against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_sharding_reference.py

The reference's mesh programs need several devices: the script runs itself
again in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``.
Its meshes are built with ``Auto`` axes (the installed JAX's default,
``Explicit``, makes the reference's sharded train step fail a sharding-type
check at its embedding lookup), and the expert-parallel block runs with
``shard_map``'s replication check off, as its mesh paths were written.

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
    sys.exit(main("_torch_sharding_cases", __doc__))

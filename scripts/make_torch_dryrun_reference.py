#!/usr/bin/env python3
"""Compute the JAX package's results for the cases of
``tests/test_torch_dryrun.py`` (``tests/_torch_dryrun_cases.py``'s
``STORED_CASES``: the planner's cell list, shape skips, depth variants,
overrides, hill-climbing cells and model FLOPs for the ten architectures;
the arguments' bytes a device of the train, prefill and decode cells of
three smoke configs with bfloat16 leaves on a data x model mesh (2, 4))
and store them in ``tests/data/torch_dryrun_reference.npz``, which that
module holds the port against.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_dryrun_reference.py

The reference's mesh programs need several devices: the script runs itself
again in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
and initialises JAX's 8 host devices before it imports the reference's
planner (whose import asks for 512 placeholder devices).  Its mesh is built
with ``Auto`` axes and ``shard_map``'s replication check off, as the other
reference scripts run it; the planner's ``dryrun_cell`` is run on that mesh
and on the smoke configs by patching its ``make_production_mesh`` and
``get_config`` for the call.

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
    sys.exit(main("_torch_dryrun_cases", __doc__))

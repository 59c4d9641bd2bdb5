"""The cases of ``tests/test_torch_dryrun.py``: the dry-run planner on the
JAX package (``compute``, run by ``scripts/make_torch_dryrun_reference.py``
on 8 host devices) and its collective rehearsal on the port's ranks
(``port``, run on ``tests/_torch_ep_cases.py``'s pool of 8 gloo ranks).

* ``planner``: for the ten architectures, ``shape_skips`` of every shape,
  the ``--all`` cell list, ``_depth_variants``, every ``hillclimb.CELLS``
  override applied by ``apply_overrides``, ``hillclimb.CELLS`` itself and
  ``model_flops`` of every cell; stored as JSON;
* ``args``: ``memory_analysis().argument_size_in_bytes`` of the reference's
  ``dryrun_cell`` for the train, prefill and decode cells of three smoke
  configs with bfloat16 leaves on a data x model mesh (2, 4) of ``Auto``
  axes (the cells' production shapes: compiled, not run);
* port-only, on the pool: one rank's train, prefill and decode steps of
  ``launch.dryrun.cell_step`` for the same configs at small shapes
  (``REHEARSAL``) on (2, 4), for real, with each step's collectives by kind
  and bytes, which the meta dry-run of the same step must equal.

The module imports neither JAX nor the port at its top.
"""
from __future__ import annotations

import dataclasses as dc
import json
from pathlib import Path

import numpy as np

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_dryrun_reference.npz"
ARCHS = ("hubert-xlarge", "mamba2-2.7b", "deepseek-v3-671b", "qwen3-moe-30b-a3b",
         "llama3-8b", "qwen2-1.5b", "mistral-large-123b", "granite-20b", "zamba2-2.7b",
         "qwen2-vl-2b")
ARG_ARCHS = ("llama3-8b", "qwen3-moe-30b-a3b", "mamba2-2.7b")  # smoke, bfloat16 leaves
ARG_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESH = ((2, 4), ("data", "model"))
# small stand-ins of the three kinds, registered in ``steps.SHAPES`` where used
REHEARSAL = {"rehearse_train": dict(kind="train", seq=16, batch=4),
             "rehearse_prefill": dict(kind="prefill", seq=32, batch=4),
             "rehearse_decode": dict(kind="decode", seq=64, batch=4)}
STORED_CASES = ("planner", "args")
POOL_CASES = ("rehearsal",)
POOL_MESH = {"rehearsal": "2x4"}


def smoke_bf16(get_config, arch: str):
    """The smoke config of ``arch`` with bfloat16 leaves (either package's
    ``get_config``)."""
    return dc.replace(get_config(arch, smoke=True), dtype="bfloat16")


def register_rehearsal(steps_module) -> None:
    steps_module.SHAPES.update(REHEARSAL)


def config_json(cfg) -> dict:
    return json.loads(json.dumps(dc.asdict(cfg), default=str))


def inputs(name: str) -> dict:
    return {}


# ---------------------------------------------------------------------------
# the reference (JAX, 8 host devices)
# ---------------------------------------------------------------------------


def compute(name: str) -> dict:
    import jax

    jax.devices()  # the 8 host devices, before the planner's import asks for 512
    import repro.distributed._compat as compat
    import repro.launch.dryrun as DR
    from repro.configs import all_arch_ids, get_config
    from repro.launch import hillclimb as HC
    from repro.launch import roofline as RL
    from repro.launch import steps as JST

    if name == "planner":
        rec = {"all_cells": [[a, s] for a in all_arch_ids() for s in JST.SHAPES],
               "cells": {k: {"arch": v["arch"], "shape": v["shape"],
                             "iters": [[t, o] for t, o in v["iters"]]}
                         for k, v in HC.CELLS.items()}}
        for arch in ARCHS:
            cfg = get_config(arch)
            a, b, units = DR._depth_variants(cfg)
            rec[arch] = {
                "skips": {s: JST.shape_skips(cfg, s) for s in JST.SHAPES},
                "depth_variants": [config_json(a), config_json(b), units],
                "model_flops": {s: RL.model_flops(cfg, JST.SHAPES[s], JST.SHAPES[s]["kind"])
                                for s in JST.SHAPES},
                "overrides": {f"{c}/{t}": config_json(DR.apply_overrides(cfg, o))
                              for c, v in HC.CELLS.items() if v["arch"] == arch
                              for t, o in v["iters"]},
            }
        return {"planner": np.array(json.dumps(rec, sort_keys=True))}
    compat._CHECK_DEFAULT = False
    shape, axes = MESH
    mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    mesh_fn, cfg_fn = DR.make_production_mesh, DR.get_config
    DR.make_production_mesh = lambda **kw: mesh
    out = {}
    try:
        for arch in ARG_ARCHS:
            DR.get_config = lambda a: smoke_bf16(cfg_fn, a)
            for cell in ARG_SHAPES:
                rec = DR.dryrun_cell(arch, cell, verbose=False)
                if rec["status"] != "ok":
                    raise RuntimeError(f"{arch} {cell}: {rec.get('error')}")
                out[f"{arch}/{cell}"] = np.int64(rec["memory"]["argument_bytes"])
    finally:
        DR.make_production_mesh, DR.get_config = mesh_fn, cfg_fn
    return out


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def rehearsal_cfg(get_config, arch: str):
    """The smoke config (float32: the CPU ranks run it for real) on the
    rehearsal's mesh axes."""
    return dc.replace(get_config(arch, smoke=True), mesh_axes=MESH[1])


def port(name: str, mesh, inp: dict, workdir: str) -> dict:
    """Each rehearsal step on this rank, for real (CPU ranks, the plain
    versions), and its collectives by kind and bytes."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import moe_parallel as MP
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as ST

    register_rehearsal(ST)
    out = {"coords": dict(mesh.coords)}
    for arch in ARG_ARCHS:
        cfg = rehearsal_cfg(get_config, arch)
        MP.set_current_mesh(mesh)
        for cell in REHEARSAL:
            fn, at_rest, _ = DR.cell_step(cfg, cell, mesh)
            before = dict(SH.COLLECTIVES)
            fn()
            out[f"{arch}/{cell}"] = {
                k: SH.COLLECTIVES[k] - before[k]
                for k in (*SH.KINDS, *(f"{k}_bytes" for k in SH.KINDS))}
            out[f"{arch}/{cell}"]["at_rest"] = at_rest
        MP.set_current_mesh(None)
    return out

"""Multi-pod dry-run of the port (counterpart of :mod:`repro.launch.dryrun`):
run one rank's step of every (architecture x input shape) cell of the
production meshes, prove its memory fits an H100 and extract its roofline
terms, with no card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod | --both-meshes] [--out f.json]

The reference compiles each cell on 512 placeholder host devices and reads
XLA's ``memory_analysis`` and ``cost_analysis``.  The port has no compiler
to ask: it runs rank 0's step eagerly on ``torch.device("meta")`` (shapes
and dtypes, nothing allocated, nothing computed) against
``sharding.meta_mesh`` of the production mesh's shape, whose collectives
return tensors of the shapes the ranks' would and count their kind and
bytes in ``sharding.COLLECTIVES`` as gloo's do.  A dry-run needs no card by
its nature.  The one value the steps read back to the host, a decode
cache's ``index``, is the static 0 of the cell's stand-in caches.

* ``memory``: ``argument_bytes`` is the rank's bytes at rest by the spec
  arithmetic (``fsdp.shard_bytes``: parameters, optimiser moments and step,
  the inputs' shards, padding included); ``temp_bytes`` the high-water mark
  of the live storage the step made (:class:`MetaTracker`), ``peak_bytes``
  their sum, ``fits_80GB`` whether it is below the H100 80GB HBM3's
  ``HBM_PER_CHIP``.  The reference halves a bfloat16 program's temp bytes
  (XLA-CPU has no bfloat16 dot, so its CPU compile holds float32 copies
  that a TPU would not); a meta run holds each tensor in the dtype the card
  would, so there is nothing to correct.
* ``roofline``: FLOPs by ``roofline.count_flops`` (``FlopCounterMode``), HBM
  bytes as each aten op's tensor inputs plus outputs (views excluded), the
  collectives' wire bytes from ``COLLECTIVES`` with the reference's wire
  factors, over ``launch.roofline``'s H100 peaks.  Every layer runs
  eagerly, so there is no scan to undercount; :func:`calibrated_roofline`
  keeps the reference's two-depth extrapolation all the same.

The MoE layers run the plain versions (``backend="torch"``), whose
products ``FlopCounterMode`` sees; the kernels compute the same functions.
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import functools
import json
import math
import time
import traceback
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import all_arch_ids, get_config
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import moe_parallel as MP
from repro_torch.distributed import sharding as SH
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import production_shape
from repro_torch.models import model as M
from repro_torch.optim.optimizers import make_optimizer

HBM_PER_CHIP = 80e9  # NVIDIA H100 80GB HBM3
# the reference's collective names (post-SPMD HLO) -> the port's kinds; gloo
# has no reduce-scatter (the port's is an all-reduce and a slice)
HLO_KINDS = {"all-gather": "all_gather", "all-reduce": "all_reduce", "reduce-scatter": None,
             "all-to-all": "all_to_all", "collective-permute": "ppermute"}


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


class MetaTracker(TorchDispatchMode):
    """Over the ops run under it: ``hbm_bytes``, the bytes of every aten
    op's tensor inputs and outputs (a view op moves none), and
    ``temp_bytes``, the high-water mark of the storages the ops made that
    are still alive (each freed when its last tensor goes)."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.live = 0
        self.temp_bytes = 0
        self._born: dict[int, tuple] = {}

    def _dead(self, key: int, _ref) -> None:
        _, n = self._born.pop(key, (None, 0))
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _is_view(func):  # no bytes moved, no storage made
            return out
        ins = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.hbm_bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        old = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in old or key in self._born:
                continue
            n = st.nbytes()
            self._born[key] = (weakref.ref(st, functools.partial(self._dead, key)), n)
            self.live += n
            self.temp_bytes = max(self.temp_bytes, self.live)
        return out


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and tree and all(isinstance(t, dict) for t in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _bytes_at_rest(tensors: dict, specs: dict, mesh) -> int:
    """A rank's bytes of global ``tensors`` (meta or host, by path) under
    ``specs`` (by the same paths; padding included)."""
    shapes = {k: tuple(t.shape) for k, t in tensors.items()}
    return FS.shard_bytes(shapes, specs, mesh, {k: t.element_size() for k, t in tensors.items()})


def _mesh(multi_pod: bool):
    return SH.meta_mesh(SH.AbstractMesh.of(*production_shape(multi_pod=multi_pod)))


def cell_step(cfg, shape: str, mesh, dispatch=None):
    """``(step, at_rest, optimizer or None)``: ``step()`` runs one rank's
    step of the cell on ``mesh`` (a ``sharding.meta_mesh``, or a mesh of
    ranks on their device: the same step, run for real), the rank's shards
    of the model, the train state and the inputs made on the mesh's device
    (the model uninitialised, the inputs zeros).  ``at_rest``: those
    shards' bytes by the spec arithmetic, by part (``params``, ``moments``
    and ``step`` of a train state, a decode cell's ``caches`` on the
    device, and the other ``inputs``, the caches' host ``index`` among
    them); their sum is the cell's ``argument_bytes``.  ``cfg`` must name the
    mesh's axes."""
    info = ST.SHAPES[shape]
    kind = info["kind"]
    dev = mesh.device
    dp = math.prod(mesh.shape[a] for a in SH.DATA_AXES if a in mesh.axis_names)
    split = info["batch"] % dp == 0
    glob = ST.input_specs(cfg, shape)
    specs = ST.batch_shardings(cfg, mesh, shape)
    every = _flat(glob)
    caches = [k for k in every if k.startswith("caches/") and not k.endswith("index")]
    at_rest = {"inputs": _bytes_at_rest({k: v for k, v in every.items() if k not in caches},
                                        _flat(specs), mesh)}  # the caches' host index too
    if caches:
        at_rest["caches"] = _bytes_at_rest({k: every[k] for k in caches}, _flat(specs), mesh)

    def zeros(batch: dict) -> dict:  # inputs (zeros) of the stand-ins' shapes
        return {k: torch.zeros(v.shape, dtype=v.dtype, device=dev) for k, v in batch.items()}

    leaves, _ = ST.abstract_init(cfg)
    if kind == "train":
        step, _, opt = ST.make_train_step(cfg, dispatch=dispatch, backend="torch", mesh=mesh)
        sh = ST.state_shardings(cfg, mesh, opt)
        abstract = ST.abstract_train_state(cfg, opt)
        at_rest["params"] = _bytes_at_rest(leaves, sh.params, mesh)
        at_rest["moments"] = sum(_bytes_at_rest(getattr(abstract, f), getattr(sh, f), mesh)
                                 for f in ("opt_m", "opt_v"))
        at_rest["step"] = 4  # the reference's int32 step
        model = M.trainable(M.uninitialized(cfg, device=dev, mesh=mesh, sharded=True))
        layout = FS.leaf_layout(mesh, M.logical_axes(cfg), M.leaf_shapes(cfg))
        opt_state = make_optimizer(opt, 1e-3, layout=layout)[0](M.param_leaves(model))
        state = ST.TrainState(model, opt_state.m, opt_state.v, 0)
        batch = zeros(ST.local_batch(glob, mesh) if split else glob)
        return (lambda: step(state, batch)), at_rest, opt
    at_rest["params"] = _bytes_at_rest(
        leaves, SH.tree_specs(M.logical_axes(cfg), SH.rules_for_mesh(mesh)), mesh)
    model = M.uninitialized(cfg, device=dev, mesh=mesh, sharded=True)
    if kind == "prefill":
        fn = ST.make_prefill_step(cfg, info["seq"], backend="torch", mesh=mesh)
        batch = zeros(glob)  # the global batch: the step takes the rank's part
        return (lambda: fn(model, batch)), at_rest, None
    fn = ST.make_serve_step(cfg, backend="torch", mesh=mesh)
    b_loc = info["batch"] // dp if split else info["batch"]
    caches = M.init_cache(cfg, b_loc, info["seq"], device=dev, mesh=mesh)
    batch = dict(zeros({k: v for k, v in glob.items() if k != "caches"}), caches=caches)
    return (lambda: fn(model, batch)), at_rest, None


def _counted(fn):
    """``(flops, MetaTracker, collectives by kind and bytes)`` over ``fn()``."""
    before = dict(SH.COLLECTIVES)
    tracker = MetaTracker()
    with tracker:
        _, flops = RL.count_flops(fn)
    coll = {k: SH.COLLECTIVES[k] - before[k] for k in SH.COLLECTIVES}
    return flops, tracker, coll


def _counts(coll: dict) -> dict:
    """Collective counts under the reference's HLO names."""
    return {name: (coll[kind] if kind else 0) for name, kind in HLO_KINDS.items()}


def _prepare(cfg, mesh):
    cfg = dc.replace(cfg, mesh_axes=tuple(mesh.axis_names))
    MP.set_current_mesh(mesh)
    return cfg


def dryrun_cell(arch: str, shape: str, *, multi_pod: bool = False,
                verbose: bool = True, dispatch: str | None = None):
    """Run one rank's step of the cell on the meta device; returns a result
    dict (or a skip record)."""
    cfg = get_config(arch)
    skip = ST.shape_skips(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi_pod else "16x16"}
    if skip:
        rec["status"] = "skip"
        rec["reason"] = skip
        return rec
    mesh = _mesh(multi_pod)
    chips = mesh.world
    kind = ST.SHAPES[shape]["kind"]
    t0 = time.time()
    try:
        cfg = _prepare(cfg, mesh)
        fn, at_rest, opt = cell_step(cfg, shape, mesh, dispatch)
        args = sum(at_rest.values())
        if opt is not None:
            rec["optimizer"] = opt
        flops, tracker, coll = _counted(fn)
        del fn
        rec["meta_run_s"] = round(time.time() - t0, 1)
        peak = args + tracker.temp_bytes
        rec["chips"] = chips
        rec["memory"] = {"argument_bytes": args, "at_rest": at_rest,
                         "temp_bytes": tracker.temp_bytes,
                         "peak_bytes": peak, "per_device_estimate": peak,
                         "fits_80GB": bool(peak < HBM_PER_CHIP)}
        by_kind = RL.collective_bytes_of(coll)
        rl = RL.from_measured(flops, tracker.hbm_bytes, sum(by_kind.values()), chips,
                              coll_breakdown=by_kind)
        rec["roofline"] = rl.as_dict()
        rec["roofline"]["collective_breakdown"] = by_kind
        rec["roofline"]["collective_counts"] = _counts(coll)
        mf = RL.model_flops(cfg, ST.SHAPES[shape], kind)
        rec["roofline"]["model_flops"] = mf
        rec["roofline"]["useful_flops_frac"] = mf / (flops * chips) if flops else None
        rec["status"] = "ok"
        if verbose:
            print(f"[{rec['mesh']}] {arch} x {shape}: OK ({rec['meta_run_s']} s on meta)")
            print("  memory:", rec["memory"])
            print("  roofline:", {k: v for k, v in rec["roofline"].items()
                                  if k != "collective_breakdown"})
    except Exception as e:  # a spec that does not split, a step that raises, ...
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc(limit=8)
        if verbose:
            print(f"[{rec['mesh']}] {arch} x {shape}: FAIL {rec['error']}")
    finally:
        MP.set_current_mesh(None)
    return rec


# ---------------------------------------------------------------------------
# calibrated roofline: the reference measures two small-depth variants at
# full width, batch and mesh and extrapolates linearly, total(L) = base +
# L * marginal, because XLA counts a scan body once.  The port counts every
# layer; the extrapolation is kept and held to the full-depth count.
# ---------------------------------------------------------------------------


def _measure_costs(cfg, shape: str, mesh, dispatch=None):
    """``(flops, hbm_bytes, collective wire bytes, collective counts)`` of
    one rank's step of ``cfg`` (per device)."""
    cfg = _prepare(cfg, mesh)
    try:
        fn, _, _ = cell_step(cfg, shape, mesh, dispatch)
        flops, tracker, coll = _counted(fn)
    finally:
        MP.set_current_mesh(None)
    return (flops, float(tracker.hbm_bytes), float(sum(RL.collective_bytes_of(coll).values())),
            _counts(coll))


def _depth_variants(cfg):
    """Two reduced-depth configs + the depth multiplier to full scale.

    For hybrid archs the repeating unit is one (period mamba + shared
    attention) group; otherwise it's a single layer of the homogeneous
    (or MoE) stack."""
    if cfg.family == "hybrid":
        per = cfg.hybrid_shared_period
        a = dc.replace(cfg, n_layers=per, scan_layers=False)
        b = dc.replace(cfg, n_layers=2 * per, scan_layers=False)
        units = cfg.n_layers // per
        return a, b, units
    if cfg.moe is not None and cfg.moe.first_k_dense:
        kd = cfg.moe.first_k_dense
        a = dc.replace(cfg, n_layers=kd + 1, scan_layers=False)
        b = dc.replace(cfg, n_layers=kd + 2, scan_layers=False)
        units = cfg.n_layers - kd
        return a, b, units
    a = dc.replace(cfg, n_layers=1, scan_layers=False)
    b = dc.replace(cfg, n_layers=2, scan_layers=False)
    units = cfg.n_layers
    return a, b, units


def apply_overrides(cfg, overrides):
    """dc.replace with dotted keys for nested configs (moe.capacity_factor)."""
    if not overrides:
        return cfg
    direct = {k: v for k, v in overrides.items() if "." not in k}
    nested = {k: v for k, v in overrides.items() if "." in k}
    if direct:
        cfg = dc.replace(cfg, **direct)
    for k, v in nested.items():
        sub, field = k.split(".", 1)
        cfg = dc.replace(cfg, **{sub: dc.replace(getattr(cfg, sub), **{field: v})})
    return cfg


def calibrated_roofline(arch: str, shape: str, *, multi_pod: bool = False,
                        dispatch: str | None = None, overrides=None):
    """Roofline terms extrapolated from two reduced depths (the reference's
    ``_depth_variants``) to the config's.  The port's counts are eager, so
    the grad-accum microbatches are already in each measurement (the
    reference scales its scanned body by ``grad_accum``)."""
    cfg = apply_overrides(get_config(arch), overrides)
    skip = ST.shape_skips(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape, "status": "skip", "reason": skip}
    mesh = _mesh(multi_pod)
    chips = mesh.world
    a, b, units = _depth_variants(cfg)
    fa, ba, ca_, _ = _measure_costs(a, shape, mesh, dispatch)
    fb, bb, cb_, cnt_b = _measure_costs(b, shape, mesh, dispatch)
    mf = max(1.0, fb - fa)
    mbytes = max(0.0, bb - ba)
    mcoll = max(0.0, cb_ - ca_)
    # the units in variant a: one group of a hybrid, a's layers past a dense prefix
    units_a = (1 if cfg.family == "hybrid"
               else a.n_layers - cfg.moe.first_k_dense
               if cfg.moe is not None and cfg.moe.first_k_dense else a.n_layers)
    base_f = max(0.0, fa - mf * units_a)
    base_b = max(0.0, ba - mbytes * units_a)
    base_c = max(0.0, ca_ - mcoll * units_a)
    flops = base_f + mf * units
    hbm = base_b + mbytes * units
    coll = base_c + mcoll * units
    info = ST.SHAPES[shape]
    rl = RL.Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll, chips=chips)
    rec = {"arch": arch, "shape": shape, "status": "ok",
           "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
           "roofline": rl.as_dict()}
    mfl = RL.model_flops(cfg, info, info["kind"])
    rec["roofline"]["model_flops"] = mfl
    rec["roofline"]["useful_flops_frac"] = mfl / (flops * chips) if flops else None
    rec["roofline"]["collective_counts"] = cnt_b
    rec["units"] = units
    return rec


def cells(all_archs: bool, arch=None, shape=None) -> list[tuple[str, str]]:
    """The ``--all`` cell list (every architecture x every shape), or the
    one cell named."""
    if all_archs:
        return [(a, s) for a in all_arch_ids() for s in ST.SHAPES]
    if not (arch and shape):
        raise ValueError("--arch/--shape or --all")
    return [(arch, shape)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dispatch", default=None, choices=[None, "dense", "sorted"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    todo = cells(args.all, args.arch, args.shape)
    meshes = [False, True] if args.both_meshes else [args.multipod]
    results = []
    for mp in meshes:
        for arch, shape in todo:
            results.append(dryrun_cell(arch, shape, multi_pod=mp, dispatch=args.dispatch))
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run: {ok} ok, {skip} skip, {err} error ==")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print("wrote", args.out)
    return 0 if err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""The cases of ``tests/test_torch_sharding.py``: parameters, moments and
batches sharded by the logical-axis rules, on the JAX package (``compute``,
run by ``scripts/make_torch_sharding_reference.py`` on 8 host devices with
meshes of ``Auto`` axes) and on the port's ranks (``port``, run on
``tests/_torch_ep_cases.py``'s pool of 8 gloo ranks).

* ``specs``: for each of the ten architectures at its published size, the
  reference's logical spec tree and leaf shapes (``abstract_init``), and on
  the meshes (2, 4), (16, 16) and (2, 16, 16) (``AbstractMesh``: specs
  only, nothing compiled) the parameters' and both optimisers' specs
  (``state_shardings``), each leaf's shard shape (GSPMD's ceiling where a
  dimension does not divide, read from the sharding's tile assignment),
  and for every shape the cell has the input stand-ins and
  ``batch_shardings``, and ``cache_specs``; stored as JSON;
* ``init-2x4``: the qwen3-moe smoke model's weights placed by those specs
  on (2, 4): every device's addressable shard, by its mesh coordinates;
* ``step-*``: two sharded train steps of a smoke config on (2, 4) from
  the same weights and batch (llama3-8b and qwen3-moe through
  ``sorted_ep`` with AdamW, mistral-large-123b with Adafactor): each
  step's loss and gradient norm, then the global parameters and moments;
* port-only, on the pool: the clip's norm with a replicated leaf and an
  uneven shard's gather, the elastic restore from (8,) to (4, 2), and
  ``train(mesh=)`` on (2, 2) with a resume, and stopped by a SIGTERM that
  only one rank has.

Inputs come from per-case NumPy seeds; weights are
``test_torch_families.family_weights``.  The module imports neither JAX
nor the port at its top: the ranks import only the port.
"""
from __future__ import annotations

import dataclasses as dc
import json
import zlib
from pathlib import Path

import numpy as np

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_sharding_reference.npz"
ARCHS = ("hubert-xlarge", "mamba2-2.7b", "deepseek-v3-671b", "qwen3-moe-30b-a3b",
         "llama3-8b", "qwen2-1.5b", "mistral-large-123b", "granite-20b", "zamba2-2.7b",
         "qwen2-vl-2b")
SPEC_MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
OPTS = ("adamw", "adafactor")
INIT_ARCH = "qwen3-moe-30b-a3b"
STEPS = {  # case -> (arch, optimizer)
    "step-llama": ("llama3-8b", "adamw"),
    "step-moe": ("qwen3-moe-30b-a3b", "adamw"),
    "step-mistral": ("mistral-large-123b", "adafactor"),
}
B, S, N_STEPS, LR = 8, 32, 2, 2e-2
TRAIN_MESH = dict(arch="llama3-8b", batch=8, seq=32, steps=3, cut=1)
STORED_CASES = ("specs", "init-2x4") + tuple(STEPS)
POOL_CASES = ("init-2x4",) + tuple(STEPS) + ("clip", "elastic", "train-mesh")
# the pool's mesh of each case (tests/_torch_ep_cases.MESHES)
POOL_MESH = {"init-2x4": "2x4", "clip": "2x4", "elastic": "8", "train-mesh": "2x2",
             **{k: "2x4" for k in STEPS}}


def case_rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def mesh_coords(shape, axes, rank: int) -> dict:
    return {a: int(c) for a, c in zip(axes, np.unravel_index(rank, shape))}


def step_cfg(get_config, name: str):
    """The case's smoke config on mesh axes ("data", "model"); qwen3-moe's
    through ``sorted_ep`` at capacity factor E/k, so that no chunk drops a
    row (either package's ``get_config``)."""
    arch, _ = STEPS[name]
    cfg = dc.replace(get_config(arch, smoke=True), mesh_axes=("data", "model"))
    if cfg.moe is not None:
        m = cfg.moe
        cfg = dc.replace(cfg, moe=dc.replace(m, dispatch="sorted_ep",
                                             capacity_factor=m.num_experts / m.top_k))
    return cfg


def inputs(name: str) -> dict:
    """The case's NumPy inputs (weights as the reference's parameter tree
    under ``"tree"``, zero moments as its optimiser makes them)."""
    rng = case_rng(name)
    if name == "init-2x4" or name in STEPS:
        from repro.configs import get_config as j_get_config
        from test_torch_families import family_weights

        arch = INIT_ARCH if name == "init-2x4" else STEPS[name][0]
        tree = family_weights(j_get_config(arch, smoke=True), rng)
        if name == "init-2x4":
            return dict(tree=tree)
        import jax

        from repro.optim import make_optimizer

        st = make_optimizer(STEPS[name][1], 1e-3)[0](tree)
        vocab = tree["embed"].shape[0]
        labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
        labels[rng.random((B, S)) < 0.1] = -1
        labels[0, :20] = -1  # the shards' mask counts differ
        return dict(tree=tree, m=jax.tree.map(np.asarray, st.m),
                    v=jax.tree.map(np.asarray, st.v),
                    tokens=rng.integers(0, vocab, (B, S)).astype(np.int32), labels=labels)
    if name == "clip":
        return dict(split=rng.standard_normal((10, 12)).astype(np.float32),  # uneven rows
                    rep=rng.standard_normal((7,)).astype(np.float32),
                    model=rng.standard_normal((6, 8)).astype(np.float32))
    if name == "elastic":
        return dict(w=np.arange(64, dtype=np.float32).reshape(8, 8),
                    b=np.ones((8,), np.float32))
    return {}


# ---------------------------------------------------------------------------
# the reference (JAX, 8 host devices, meshes of Auto axes)
# ---------------------------------------------------------------------------


def spec_json(spec) -> list:
    """A spec (a ``PartitionSpec`` or the port's tuple) as JSON: an entry
    None, a mesh axis, or a list of them."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def flat_paths(tree, prefix: str = "") -> dict:
    """A tree of dicts, tuples and lists by ``/``-joined path (a tuple of
    logical names or a spec is a leaf)."""
    from jax.sharding import PartitionSpec

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec) and tree \
            and all(isinstance(t, (dict, list, tuple)) for t in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_paths(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _jax_mesh(shape, axes):
    import jax

    return jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def _shard_shape(sharding, shape) -> list:
    """GSPMD's shard shape: ``shard_shape`` where every dimension divides,
    else ``ceil(n / tiles)`` from the sharding's tile assignment (XLA pads
    the last blocks)."""
    try:
        return list(sharding.shard_shape(tuple(shape)))
    except ValueError:
        tiles = sharding._to_xla_hlo_sharding(len(shape)).tile_assignment_dimensions()
        return [-(-int(n) // int(t)) for n, t in zip(shape, tiles)]


def compute_specs() -> dict:
    import jax
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import get_config as j_get_config
    from repro.distributed import sharding as JSH
    from repro.launch import steps as JST

    out = {}
    for arch in ARCHS:
        cfg = j_get_config(arch)
        shapes, logical = JST.abstract_init(cfg)
        leaves = flat_paths(jax.tree.map(lambda s: (list(s.shape), str(s.dtype)), shapes,
                                         is_leaf=lambda s: hasattr(s, "shape")))
        rec = {"axes": {k: list(v) for k, v in flat_paths(logical).items()},
               "leaves": leaves, "meshes": {}}
        for mname, (mshape, axes) in SPEC_MESHES.items():
            mesh = AbstractMesh(mshape, axes)
            m = {}
            for opt in OPTS:
                st = JST.state_shardings(cfg, mesh, opt)
                for field in ("params", "opt_m", "opt_v"):
                    m[f"{opt}/{field}"] = {k: spec_json(v.spec) for k, v in
                                           flat_paths(getattr(st, field)).items()}
                m[f"{opt}/step"] = spec_json(st.step.spec)
            pspecs = JSH.tree_specs(logical, JSH.rules_for_mesh(mesh))
            m["shard_shapes"] = {
                k: _shard_shape(NamedSharding(mesh, flat_paths(pspecs)[k]), leaves[k][0])
                for k in leaves}
            cells = {}
            for shape in JST.SHAPES:
                if JST.shape_skips(cfg, shape):
                    continue
                ins = flat_paths(JST.input_specs(cfg, shape))
                bsh = flat_paths(JST.batch_shardings(cfg, mesh, shape))
                cells[shape] = {"inputs": {k: [list(v.shape), str(v.dtype)]
                                           for k, v in ins.items()},
                                "specs": {k: spec_json(v.spec) for k, v in bsh.items()}}
            m["cells"] = cells
            m["cache"] = {k: spec_json(v) for k, v in
                          flat_paths(JSH.cache_specs(cfg, mesh)).items()}
            rec["meshes"][mname] = m
        out[arch] = np.array(json.dumps(rec, sort_keys=True))
    return out


def compute_init() -> dict:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.configs import get_config as j_get_config
    from repro.distributed import sharding as JSH
    from repro.launch import steps as JST

    mesh = _jax_mesh((2, 4), ("data", "model"))
    cfg = dc.replace(j_get_config(INIT_ARCH, smoke=True), mesh_axes=("data", "model"))
    _, logical = JST.abstract_init(cfg)
    specs = flat_paths(JSH.tree_specs(logical, JSH.rules_for_mesh(mesh)))
    tree = flat_paths(inputs("init-2x4")["tree"])
    devices = np.asarray(mesh.devices)
    out = {}
    for k, a in tree.items():
        placed = jax.device_put(a, NamedSharding(mesh, PartitionSpec(*specs[k])))
        for shard in placed.addressable_shards:
            d, m = (int(c) for c in np.argwhere(devices == shard.device)[0])
            out[f"{k}@{d},{m}"] = np.asarray(shard.data)
    return out


def compute_step(name: str) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    import repro.distributed._compat as compat
    from repro.configs import get_config as j_get_config
    from repro.distributed import moe_parallel as JMP
    from repro.distributed import sharding as JSH
    from repro.launch import steps as JST

    compat._CHECK_DEFAULT = False  # the EP block as written (check_vma rejects it)
    mesh = _jax_mesh((2, 4), ("data", "model"))
    JMP.set_current_mesh(mesh)
    cfg = step_cfg(j_get_config, name)
    inp = inputs(name)
    step, _, opt = JST.make_train_step(cfg, optimizer=STEPS[name][1], lr=LR)
    psh = JST.state_shardings(cfg, mesh, opt)
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "labels")}
    bsh = {k: NamedSharding(mesh, JSH.batch_spec(mesh, v.ndim)) for k, v in batch.items()}
    state = JST.TrainState(jax.tree.map(jnp.asarray, inp["tree"]),
                           jax.tree.map(jnp.asarray, inp["m"]),
                           jax.tree.map(jnp.asarray, inp["v"]), jnp.int32(0))
    losses, norms = [], []
    with mesh:
        state = jax.device_put(state, psh)
        batch = {k: jax.device_put(v, bsh[k]) for k, v in batch.items()}
        fn = jax.jit(step, in_shardings=(psh, bsh), out_shardings=(psh, None))
        for _ in range(N_STEPS):
            state, met = fn(state, batch)
            losses.append(np.asarray(met["loss"]))
            norms.append(np.asarray(met["grad_norm"]))
    out = {"loss": np.stack(losses), "grad_norm": np.stack(norms)}
    for field, tag in (("params", "params"), ("opt_m", "m"), ("opt_v", "v")):
        out.update({f"{tag}/{k}": np.asarray(v)
                    for k, v in flat_paths(getattr(state, field)).items()})
    return out


def compute(name: str) -> dict:
    if name == "specs":
        return compute_specs()
    if name == "init-2x4":
        return compute_init()
    return compute_step(name)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def port(name: str, mesh, inp: dict, workdir: str) -> dict:
    """The case on this rank of ``mesh`` (CPU ranks, the plain versions)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import model as M

    if name == "init-2x4":
        cfg = dc.replace(get_config(INIT_ARCH, smoke=True), mesh_axes=("data", "model"))
        model = M.params_from_numpy(cfg, inp["tree"], device="cpu", mesh=mesh, sharded=True)
        return dict(coords=dict(mesh.coords),
                    shards={n: t.numpy().copy() for n, t in model.named_parameters()})
    if name in STEPS:
        from repro_torch.launch import steps as ST

        cfg = step_cfg(get_config, name)
        before = dict(SH.COLLECTIVES)
        state = M.train_state_from_numpy(cfg, inp["tree"], inp["m"], inp["v"], 0,
                                         device="cpu", mesh=mesh)
        step, _, _ = ST.make_train_step(cfg, optimizer=STEPS[name][1], lr=LR, mesh=mesh)
        batch = ST.local_batch({k: torch.from_numpy(inp[k]) for k in ("tokens", "labels")},
                               mesh)
        losses, norms = [], []
        for _ in range(N_STEPS):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        return dict(coords=dict(mesh.coords), losses=losses, norms=norms,
                    params={n: t.detach().numpy().copy()
                            for n, t in state.params.named_parameters()},
                    m={k: v.numpy().copy() for k, v in state.opt_m.items()},
                    v={k: v.numpy().copy() for k, v in state.opt_v.items()},
                    collectives={k: SH.COLLECTIVES[k] - before[k] for k in SH.KINDS})
    if name == "clip":
        from repro_torch.distributed import fsdp as FS
        from repro_torch.optim import clip_by_global_norm

        specs = {"split": ("data", "model"), "rep": (None,), "model": (None, "model")}
        layout = FS.LeafLayout(mesh, specs, {k: inp[k].shape for k in specs})
        grads = {k: SH.shard_of(torch.from_numpy(inp[k]), specs[k], mesh) for k in specs}
        _, norm = clip_by_global_norm(grads, 1.0, layout)
        whole = {k: SH.gather_full(g, specs[k], mesh, inp[k].shape).numpy()
                 for k, g in grads.items()}
        return dict(norm=float(norm), clipped=whole, coords=dict(mesh.coords),
                    split_shard=grads["split"].numpy().copy(),
                    valid=[(s.start, s.stop) for s in
                           SH.valid_slices(inp["split"].shape, specs["split"], mesh)])
    if name == "elastic":
        from repro_torch.checkpoint import CheckpointManager

        d = Path(workdir)
        tree = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
        sh8 = {"w": ("data", None), "b": (None,)}
        tree8 = {k: SH.shard_of(v, sh8[k], mesh) for k, v in tree.items()}
        mgr = CheckpointManager(str(d), keep=2)
        mgr.save(tree8, 10, extras={"loader": {"seed": 1, "step": 10}}, mesh=mesh, specs=sh8)
        SH.barrier(mesh.sub(mesh.axis_names))
        mesh4 = SH.make_mesh((4, 2), ("data", "model"), device="cpu")
        sh4 = {"w": ("data", "model"), "b": ("model",)}
        like = {k: torch.zeros_like(v) for k, v in tree.items()}
        restored, manifest = mgr.restore(like, mesh=mesh4, specs=sh4)
        return dict(coords8=dict(mesh.coords), coords4=dict(mesh4.coords),
                    step=manifest["step"], loader=manifest["extras"]["loader"],
                    shards={k: v.numpy().copy() for k, v in restored.items()},
                    devices={k: str(v.device) for k, v in restored.items()})
    if name == "train-mesh":
        from repro_torch.launch import train as TR

        d = Path(workdir)
        kw = dict(smoke=True, batch=TRAIN_MESH["batch"], seq=TRAIN_MESH["seq"],
                  log_every=100, device="cpu", mesh=mesh)
        full = TR.train(TRAIN_MESH["arch"], steps=TRAIN_MESH["steps"],
                        ckpt_dir=str(d / "full"), **kw)
        first = TR.train(TRAIN_MESH["arch"], steps=TRAIN_MESH["cut"], ckpt_dir=str(d / "cut"),
                         save_every=TRAIN_MESH["cut"], **kw)
        rest = TR.train(TRAIN_MESH["arch"], steps=TRAIN_MESH["steps"], ckpt_dir=str(d / "cut"),
                        resume=True, save_every=100, **kw)
        stopped, resumed = preempted_run(TR, mesh, str(d / "preempted"), kw)
        return dict(full=full, first=first, rest=rest, stopped=stopped, resumed=resumed)
    raise KeyError(name)


def preempted_run(TR, mesh, ckpt: str, kw: dict) -> tuple[list, list]:
    """``train(mesh=)`` where rank 1 alone has a SIGTERM while it loads the
    batch of step ``TRAIN_MESH["cut"] + 1``, then a resume to the end: the
    losses of both runs."""
    import os
    import signal

    loader = TR.DataLoader

    class Preempting(loader):
        def next(self):
            if mesh.rank == 1 and self.state()["step"] == TRAIN_MESH["cut"]:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().next()

    TR.DataLoader = Preempting
    try:
        stopped = TR.train(TRAIN_MESH["arch"], steps=TRAIN_MESH["steps"], ckpt_dir=ckpt,
                           save_every=100, **kw)
    finally:
        TR.DataLoader = loader
    resumed = TR.train(TRAIN_MESH["arch"], steps=TRAIN_MESH["steps"], ckpt_dir=ckpt,
                       resume=True, save_every=100, **kw)
    return stopped, resumed


def card_rank_main(rank: int, world: int, rdv: str, out) -> None:
    """A rank of ``tests/test_torch_cuda.py``'s sharded-step test: ranks
    sharing the card over gloo take one float32 sharded train step of the
    qwen3-moe smoke config (``sorted_ep``, capacity factor E/k) on meshes
    (2, 1) and (1, 2), once with the kernels and once with the plain
    versions from the same draw and batch.  Puts ``(rank, result or
    traceback)`` on ``out``."""
    import traceback

    import torch

    try:
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.kernels import ops
        from repro_torch.launch import steps as ST

        torch.backends.cuda.matmul.allow_tf32 = False
        SH.init_distributed(backend="gloo", num_processes=world, process_id=rank,
                            init_method=f"file://{rdv}", timeout_s=120)
        dev = torch.device("cuda", 0)
        res = {}
        for shape in ((2, 1), (1, 2)):
            mesh = SH.make_mesh(shape, ("data", "model"), device=dev)
            cfg = step_cfg(get_config, "step-moe")
            batch = {k: torch.from_numpy(v).to(dev) for k, v in card_batch(cfg).items()}
            for backend in ("cuda", "torch"):
                step, init, _ = ST.make_train_step(cfg, lr=LR, backend=backend, mesh=mesh)
                state = init(torch.Generator(device=dev).manual_seed(1))
                ops.reset_launch_counts()
                state, met = step(state, ST.local_batch(batch, mesh))
                res[f"{shape} {backend}"] = dict(
                    loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                    launches=dict(ops.LAUNCHES),
                    params={n: t.detach().cpu().numpy() for n, t in
                            state.params.named_parameters()},
                    m={k: t.cpu().numpy() for k, t in state.opt_m.items()},
                    v={k: t.cpu().numpy() for k, t in state.opt_v.items()})
        out.put((rank, res))
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001  (reported to the test, which fails)
        out.put((rank, traceback.format_exc()))


def card_batch(cfg) -> dict:
    rng = case_rng("card-step")
    return {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int64) for k in ("tokens", "labels")}

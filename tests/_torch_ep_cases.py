"""The cases of ``tests/test_torch_ep.py``: expert parallelism, the ring
all-gather matmul and the GPipe pipeline, on the JAX package (``compute``,
run by ``scripts/make_torch_ep_reference.py`` on 8 host devices) and on the
port's ranks (``rank_main``, one spawned process a rank, joined over gloo).
The same pool of ranks runs ``tests/_torch_sharding_cases.py``'s,
``tests/_torch_sharded_serve_cases.py``'s and ``tests/_torch_dryrun_cases.py``'s
``POOL_CASES`` (``POOL_CASES`` here: every case, in order).

Inputs come from per-case NumPy seeds; the MoE weights are the smoke
model's (``test_torch_families.family_weights``), carried to both packages
through ``params_from_numpy``.  The module imports neither JAX nor the
port at its top: the ranks import only the port.
"""
from __future__ import annotations

import dataclasses as dc
import zlib
from pathlib import Path

import numpy as np

import _torch_dryrun_cases as DC
import _torch_sharded_serve_cases as SV
import _torch_sharding_cases as SC

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_ep_reference.npz"
ARCH = "qwen3-moe-30b-a3b"
POOL_WORLD = 8
B, S = 4, 128  # the reference test's block input
LEAVES = ("router/kernel", "wi", "wg", "wo")
# mesh name -> (shape, axes, ranks of the pool); made in this order on every rank
MESHES = {
    "2x4": ((2, 4), ("data", "model"), None),
    "1x4": ((1, 4), ("data", "model"), range(4)),
    "2x2": ((2, 2), ("data", "model"), range(4)),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), None),
    "ring4": ((4,), ("model",), range(4)),
    "ring8": ((8,), ("model",), None),
    "pipe4": ((4,), ("pod",), range(4)),
    "pair": ((2,), ("pair",), range(2)),
    "8": ((8,), ("data",), None),
}
# the reference test's EP case (moe_chunk 64, capacity factor 4: no chunk
# overflows), on four meshes, and at capacity factor 1 (chunks overflow)
BLOCKS = {
    "ep-2x4": dict(mesh="2x4", cf=4.0),
    "ep-2x4-cf1": dict(mesh="2x4", cf=1.0),
    "ep-1x4": dict(mesh="1x4", cf=4.0),
    "ep-2x2": dict(mesh="2x2", cf=4.0),
    "ep-2x2x2": dict(mesh="2x2x2", cf=4.0),
}
SERVE = dict(mesh="2x2", batch=4, prompt=32, gen=5, max_len=64)  # prefill + 4 decode steps
RINGS = {"ring-w4": "ring4", "ring-w8": "ring8"}
RING_SHAPE = (64, 128, 96)  # x (S, D), w (D, F): the reference test's
PIPELINE = dict(mesh="pipe4", layers=8, batch=16, d=32, microbatches=4)
STORED_CASES = tuple(BLOCKS) + ("serve-2x2",) + tuple(RINGS) + ("pipeline",)
GRADCHECKS = ("boundary", "psum", "pmean", "all_gather_tiled", "all_to_all_blocks",
              "ppermute")
# every case the pool runs, in order: these and tests/test_torch_sharding.py's
POOL_CASES = STORED_CASES + ("gradcheck",) + SC.POOL_CASES + SV.POOL_CASES + DC.POOL_CASES
# the modules whose cases run on the pool by their own ``port``
OTHER_CASES = (SC, SV, DC)


def case_rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _module_of(name: str):
    return next((m for m in OTHER_CASES if name in m.POOL_MESH), None)


def mesh_of(name: str) -> str:
    if _module_of(name) is not None:
        return _module_of(name).POOL_MESH[name]
    if name in BLOCKS:
        return BLOCKS[name]["mesh"]
    return {"serve-2x2": SERVE["mesh"], "pipeline": PIPELINE["mesh"],
            "gradcheck": "pair"}.get(name) or RINGS[name]


def block_cfg(get_config, name: str):
    """The smoke config with the case's mesh axes, ``moe_chunk`` 64 and
    capacity factor (either package's ``get_config``)."""
    shape, axes, _ = MESHES[BLOCKS[name]["mesh"]]
    cfg = dc.replace(get_config(ARCH, smoke=True), mesh_axes=axes, moe_chunk=64)
    return dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=BLOCKS[name]["cf"],
                                          dispatch="sorted_ep"))


def serve_cfg(get_config):
    cfg = dc.replace(get_config(ARCH, smoke=True), mesh_axes=MESHES[SERVE["mesh"]][1])
    return dc.replace(cfg, moe=dc.replace(cfg.moe, dispatch="sorted_ep"))


def pool_inputs(name: str, workdir: Path) -> dict:
    """A pool case's inputs, and the directory its ranks share."""
    mod = _module_of(name)
    inp = mod.inputs(name) if mod is not None else inputs(name)
    return dict(inp, _workdir=str(workdir / f"case_{name}"))


def inputs(name: str) -> dict:
    """The case's NumPy inputs (the model's weights as the reference's
    parameter tree under ``"tree"``)."""
    rng = case_rng(name)
    if name in BLOCKS or name == "serve-2x2":
        from repro.configs import get_config as j_get_config
        from test_torch_families import family_weights

        tree = family_weights(j_get_config(ARCH, smoke=True), rng)
        d = tree["embed"].shape[1]
        if name in BLOCKS:
            return dict(tree=tree, x=rng.standard_normal((B, S, d)).astype(np.float32),
                        ct=rng.standard_normal((B, S, d)).astype(np.float32))
        vocab = tree["embed"].shape[0]
        tokens = rng.integers(0, vocab, (SERVE["batch"], SERVE["prompt"] + SERVE["gen"] - 1))
        return dict(tree=tree, tokens=tokens.astype(np.int32))
    if name in RINGS:
        s, d, f = RING_SHAPE
        return dict(x=rng.standard_normal((s, d)).astype(np.float32),
                    w=rng.standard_normal((d, f)).astype(np.float32))
    if name == "pipeline":
        n, b, d = PIPELINE["layers"], PIPELINE["batch"], PIPELINE["d"]
        return dict(params=(rng.standard_normal((n, d, d)) / np.sqrt(d)).astype(np.float32),
                    x=rng.standard_normal((b, d)).astype(np.float32),
                    ct=rng.standard_normal((b, d)).astype(np.float32))
    return {}


def drops(idx: np.ndarray, n_shards: int, chunk: int, e: int, cap: int) -> int:
    """Rows the EP dispatch drops for top-k ids ``idx`` (B, S, K): per data
    shard and chunk of ``chunk`` tokens, each expert's rows past ``cap``."""
    per_shard = idx.reshape(n_shards, -1, idx.shape[-1])
    total = 0
    for shard in per_shard:
        for c in range(0, shard.shape[0], chunk):
            counts = np.bincount(shard[c:c + chunk].reshape(-1), minlength=e)
            total += int(np.maximum(counts - cap, 0).sum())
    return total


# ---------------------------------------------------------------------------
# the reference (JAX, 8 host devices, shard_map's replication check off)
# ---------------------------------------------------------------------------


def _jax_mesh(shape, axes):
    """A JAX mesh of ``Auto`` axes, the kind the reference's mesh paths were
    written for (the installed JAX's default, ``Explicit``, makes its decode
    cache update fail a sharding-type check)."""
    import jax

    return jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def compute(name: str) -> dict:
    import jax
    import jax.numpy as jnp

    import repro.distributed._compat as compat
    from repro.configs import get_config as j_get_config
    from repro.distributed import moe_parallel as JMP

    compat._CHECK_DEFAULT = False  # the mesh paths as written (check_vma rejects them)
    inp = inputs(name)
    if name in BLOCKS:
        from repro.models import moe as JMOE

        shape, axes, _ = MESHES[BLOCKS[name]["mesh"]]
        mesh = _jax_mesh(shape, axes)
        JMP.set_current_mesh(mesh)
        cfg = block_cfg(j_get_config, name)
        moe_p = jax.tree.map(lambda a: jnp.asarray(a[0]), inp["tree"]["layers"])["moe"]
        x, ct = jnp.asarray(inp["x"]), jnp.asarray(inp["ct"])

        def loss(p, xx):
            y, aux = JMOE.moe_block(p, cfg, xx, dispatch="sorted_ep")
            return (y * ct).sum() + aux, (y, aux)

        with mesh:
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(moe_p, x)
        idx = JMOE._router(moe_p, cfg, x)[0]
        out = dict(y=y, aux=aux, dx=gx, idx=idx)
        out.update({f"g_{leaf}": gp["router"]["kernel"] if leaf == "router/kernel" else gp[leaf]
                    for leaf in LEAVES})
        return {k: np.asarray(v) for k, v in out.items()}
    if name == "serve-2x2":
        from repro.launch import steps as JST

        shape, axes, _ = MESHES[SERVE["mesh"]]
        mesh = _jax_mesh(shape, axes)
        JMP.set_current_mesh(mesh)
        cfg = serve_cfg(j_get_config)
        params = jax.tree.map(jnp.asarray, inp["tree"])
        tokens, p = inp["tokens"], SERVE["prompt"]
        with mesh:
            prefill = jax.jit(JST.make_prefill_step(cfg, SERVE["max_len"]))
            decode = jax.jit(JST.make_serve_step(cfg))
            logits, caches = prefill(params, {"tokens": jnp.asarray(tokens[:, :p])})
            kept = [logits[:, -1]]
            for i in range(SERVE["gen"] - 1):
                step = {"token": jnp.asarray(tokens[:, p + i:p + i + 1]), "caches": caches}
                logits, caches = decode(params, step)
                kept.append(logits[:, -1])
        return {"logits": np.stack([np.asarray(v, np.float32) for v in kept], 1)}
    if name in RINGS:
        from repro.distributed.overlap import reference_allgather_matmul, ring_allgather_matmul

        mesh = _jax_mesh(MESHES[RINGS[name]][0], ("model",))
        x, w = jnp.asarray(inp["x"]), jnp.asarray(inp["w"])
        with mesh:
            ring = jax.jit(ring_allgather_matmul(mesh))(x, w)
            ref = jax.jit(reference_allgather_matmul(mesh))(x, w)
        return {"ring": np.asarray(ring), "gathered": np.asarray(ref)}
    if name == "pipeline":
        from repro.distributed.pipeline import make_pipeline

        mesh = _jax_mesh(MESHES[PIPELINE["mesh"]][0], ("pod",))
        pipe = make_pipeline(mesh, lambda w, h: jnp.tanh(h @ w), PIPELINE["layers"],
                             microbatches=PIPELINE["microbatches"])
        params, x, ct = (jnp.asarray(inp[k]) for k in ("params", "x", "ct"))
        with mesh:
            y = jax.jit(pipe)(params, x)
            gp, gx = jax.jit(jax.grad(lambda p, xx: (pipe(p, xx) * ct).sum(),
                                      argnums=(0, 1)))(params, x)
        return {"y": np.asarray(y), "g_params": np.asarray(gp), "dx": np.asarray(gx)}
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def _grads_of(moe) -> dict:
    return {f"g_{leaf}": (moe.router.kernel if leaf == "router/kernel"
                          else getattr(moe, leaf)).grad.numpy() for leaf in LEAVES}


def port(name: str, mesh, inp: dict) -> dict:
    """The case on this rank of ``mesh`` (the plain versions: CPU ranks)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import moe_parallel as MP
    from repro_torch.distributed import sharding
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    before = dict(sharding.COLLECTIVES)

    def counted() -> dict:
        return {k: sharding.COLLECTIVES[k] - before[k] for k in sharding.KINDS}

    if name in BLOCKS:
        cfg = block_cfg(get_config, name)
        MP.set_current_mesh(mesh)
        moe = M.params_from_numpy(cfg, inp["tree"], device="cpu", mesh=mesh).layers[0].moe
        for t in moe.parameters():
            t.requires_grad_(True)
        dp = mesh.sub(MP.data_axes(cfg, mesh))
        rows = slice(dp.rank * (B // dp.world), (dp.rank + 1) * (B // dp.world))
        x = torch.from_numpy(inp["x"][rows]).requires_grad_(True)
        seen, route = [], MOE._route

        def tap(*args, **kw):
            out = route(*args, **kw)
            seen.append(out[0].numpy())
            return out

        MOE._route = tap
        try:
            y, aux = MOE.moe_block(moe, cfg, x, dispatch="sorted_ep", backend="torch")
            ((y * torch.from_numpy(inp["ct"][rows])).sum() + aux).backward()
        finally:
            MOE._route = route
        return dict(y=y.detach().numpy(), aux=aux.detach().numpy(), dx=x.grad.numpy(),
                    idx=seen[0], collectives=counted(), **_grads_of(moe))
    if name == "serve-2x2":
        from repro_torch.launch.serve import generate

        cfg = serve_cfg(get_config)
        MP.set_current_mesh(mesh)
        model = M.params_from_numpy(cfg, inp["tree"], device="cpu", mesh=mesh)
        dp = mesh.sub(MP.data_axes(cfg, mesh))
        n = SERVE["batch"] // dp.world
        tokens = inp["tokens"][dp.rank * n:(dp.rank + 1) * n]
        p = SERVE["prompt"]
        out = generate(model, cfg, tokens[:, :p], gen=SERVE["gen"], max_len=SERVE["max_len"],
                       backend="torch", force=tokens[:, p:], keep_logits=True)
        return dict(logits=out.logits, collectives=counted())
    if name in RINGS:
        from repro_torch.distributed.overlap import (
            reference_allgather_matmul,
            ring_allgather_matmul,
        )

        x = torch.from_numpy(sharding.local_slice(inp["x"], mesh.sub("model")))
        w = torch.from_numpy(inp["w"])
        ring = ring_allgather_matmul(mesh)(x, w).numpy()
        ring_counts = counted()
        before = dict(sharding.COLLECTIVES)
        gathered = reference_allgather_matmul(mesh)(x, w).numpy()
        return dict(ring=ring, gathered=gathered, ring_collectives=ring_counts,
                    gathered_collectives=counted())
    if name == "pipeline":
        from repro_torch.distributed.pipeline import make_pipeline

        stages = mesh.sub("pod")
        per = PIPELINE["layers"] // stages.world
        params = torch.from_numpy(inp["params"][stages.rank * per:(stages.rank + 1) * per])
        params.requires_grad_(True)
        x = torch.from_numpy(inp["x"]).requires_grad_(True)
        pipe = make_pipeline(mesh, lambda w, h: torch.tanh(h @ w), PIPELINE["layers"],
                             microbatches=PIPELINE["microbatches"])
        y = pipe(params, x)
        (y * torch.from_numpy(inp["ct"])).sum().backward()
        return dict(y=y.detach().numpy(), g_params=params.grad.numpy(), dx=x.grad.numpy(),
                    collectives=counted())
    if name == "gradcheck":
        return {op: gradcheck(op, mesh) for op in GRADCHECKS}
    raise KeyError(name)


def gradcheck(op: str, mesh) -> bool:
    """``torch.autograd.gradcheck`` of a differentiable collective in float64
    on this rank.  Every rank checks the same global function of the same
    global input X (2, 3), perturbed in lockstep: X enters as replicated
    (``replicated_input``), this rank applies ``op`` to its row, the rows
    are gathered (``all_gather_tiled``) and leave as one replicated value
    (``replicated_output``); ``"boundary"`` is that frame alone.  So each
    rank's numerical Jacobian is the global function's, and its analytical
    one the collectives' backwards combined."""
    import torch

    from repro_torch.distributed import sharding

    m = mesh.sub("pair")

    def apply(t):
        if op == "boundary":
            return t
        if op == "psum":
            return sharding.psum(m, t)
        if op == "pmean":
            return sharding.pmean(m, t)
        if op == "all_gather_tiled":
            return sharding.all_gather_tiled(m, t[None], dim=1)[0]
        if op == "all_to_all_blocks":
            return sharding.all_to_all_blocks(m, t.reshape(m.world, -1) * (m.rank + 1))
        return sharding.ppermute(m, t * (m.rank + 2))

    def fn(x):
        mine = sharding.replicated_input(m, x)[m.rank]
        out = apply(mine).reshape(1, -1)
        return sharding.replicated_output(m, sharding.all_gather_tiled(m, out, dim=0))

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((m.world, 3) if op != "all_to_all_blocks" else (m.world, 2 * m.world),
                    generator=gen, dtype=torch.float64, requires_grad=True)
    return bool(torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-8, rtol=1e-6))


def rank_main(rank: int, world: int, rdv: str, tasks, results) -> None:
    """A rank of the pool: join the gloo world at ``rdv``, make every mesh
    of ``MESHES`` (in order, on every rank), then run each ``(name,
    inputs)`` ``tasks`` delivers on the case's mesh and put ``(rank, name,
    status, result)`` on ``results`` (None: stop).  Also reports whether
    JAX or the reference package was imported in this process."""
    import sys
    import traceback

    import torch

    from repro_torch.distributed import sharding

    torch.set_num_threads(1)
    sharding.init_distributed(backend="gloo", num_processes=world, process_id=rank,
                              init_method=f"file://{rdv}", timeout_s=120)
    meshes = {k: sharding.make_mesh(shape, axes, device="cpu", ranks=ranks)
              for k, (shape, axes, ranks) in MESHES.items()}
    while True:
        task = tasks.get()
        if task is None:
            break
        name, inp = task
        workdir = inp.pop("_workdir")
        mesh = meshes[mesh_of(name)]
        if mesh is None:
            results.put((rank, name, "idle", None))
            continue
        try:
            mod = _module_of(name)
            out = (mod.port(name, mesh, inp, workdir) if mod is not None
                   else port(name, mesh, inp))
            out["imported"] = sorted(m for m in ("jax", "repro") if m in sys.modules)
            results.put((rank, name, "ok", out))
        except Exception:  # reported to the test, which fails the case
            results.put((rank, name, "error", traceback.format_exc()))


def card_rank_main(rank: int, world: int, rdv: str, out) -> None:
    """A rank of ``tests/test_torch_cuda.py``'s EP test: ranks sharing the
    card over gloo on mesh (1, world), the smoke config's EP block (float32,
    ``moe_chunk`` 64) forward and backward with the kernels and with the
    plain versions on the same inputs, and a bfloat16 forward with the
    kernels.  Puts ``(rank, result or traceback)`` on ``out``."""
    import traceback

    import torch

    try:
        from repro_torch.configs import get_config
        from repro_torch.distributed import moe_parallel as MP
        from repro_torch.distributed import sharding
        from repro_torch.kernels import ops
        from repro_torch.models import moe as MOE

        torch.backends.cuda.matmul.allow_tf32 = False
        sharding.init_distributed(backend="gloo", num_processes=world, process_id=rank,
                                  init_method=f"file://{rdv}", timeout_s=120)
        dev = torch.device("cuda", 0)
        mesh = sharding.make_mesh((1, world), ("data", "model"), device=dev)
        MP.set_current_mesh(mesh)
        cfg = dc.replace(get_config(ARCH, smoke=True), mesh_axes=("data", "model"),
                         moe_chunk=64)
        cfg = dc.replace(cfg, moe=dc.replace(cfg.moe, dispatch="sorted_ep"))
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(1)
            moe = MOE.MoE(cfg, dtype=dtype, device=dev, gen=gen,
                          experts=MP.expert_slice(cfg, mesh))
            x = torch.randn((2, 128, cfg.d_model), generator=gen, device=dev).to(dtype)
            ct = torch.randn(x.shape, generator=gen, device=dev).to(dtype)
            for backend in ("cuda", "torch"):
                ops.reset_launch_counts()
                for t in moe.parameters():
                    t.requires_grad_(dtype == torch.float32)
                    t.grad = None
                xi = x.clone().requires_grad_(dtype == torch.float32)
                y, aux = MOE.moe_block(moe, cfg, xi, backend=backend)
                got = dict(y=y.detach().float().cpu().numpy(), aux=float(aux.detach()))
                if dtype == torch.float32:
                    ((y * ct).sum() + aux).backward()
                    got.update(dx=xi.grad.cpu().numpy(), **{
                        f"g_{n}": getattr(moe, n).grad.cpu().numpy() for n in ("wi", "wg", "wo")},
                        g_router=moe.router.kernel.grad.cpu().numpy())
                got["launches"] = dict(ops.LAUNCHES)
                res[f"{str(dtype)[6:]} {backend}"] = got
        out.put((rank, res))
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001  (reported to the test, which fails)
        out.put((rank, traceback.format_exc()))

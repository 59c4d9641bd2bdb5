"""The cases of ``tests/test_torch_sharded_serve.py``: sharded serving on a
data x model mesh (2, 4), on the JAX package (``compute``, run by
``scripts/make_torch_sharded_serve_reference.py`` on 8 host devices with
meshes of ``Auto`` axes and ``shard_map``'s replication check off) and on
the port's ranks (``port``, run on ``tests/_torch_ep_cases.py``'s pool of 8
gloo ranks).

Each case is a smoke config in float32, its weights
``test_torch_families.family_weights``, served twice (``VARIANTS``):
``bf16``, the reference's prefill step jitted with its parameters on the
logical-axis rules and its caches on ``cache_specs`` (K/V in bfloat16,
Mamba's state in float32, as its ``init_cache`` makes them), then two of
its decode steps, teacher-forced; ``f32``, the same with every cache in
float32 (its ``forward`` and ``decode_step`` under the same shardings),
so that no bfloat16 rounding of float32 noise stands between the two
packages.  Stored by variant: the logits of the three steps, every
device's addressable shard of every cache leaf after the last step (by
the device's mesh coordinates) and its shard shape, and the caches'
``index``.

The module imports neither JAX nor the port at its top: the ranks import
only the port.
"""
from __future__ import annotations

import dataclasses as dc
import zlib
from pathlib import Path

import numpy as np

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_sharded_serve_reference.npz"
MESH = ((2, 4), ("data", "model"))
B, S, STEPS, MAX_LEN = 4, 32, 2, 64  # prompt of one attention chunk; 64 cache positions
# case -> (arch, config changes, the route its caches take on (2, 4))
CASES = {
    "serve-llama": ("llama3-8b", {}, "seq"),  # 2 KV heads on 4 model ranks
    "serve-llama-dup": ("llama3-8b", {"kv_dup": 2}, "heads"),
    "serve-moe": ("qwen3-moe-30b-a3b", {"dispatch": "sorted_ep"}, "seq"),  # 2 KV heads
    "serve-deepseek": ("deepseek-v3-671b", {}, "mla"),
    "serve-mamba": ("mamba2-2.7b", {}, "mamba"),
    "serve-zamba": ("zamba2-2.7b", {}, "mamba+heads"),
    "serve-vl": ("qwen2-vl-2b", {}, "seq"),
    # a batch of 3 does not divide the 2 data ranks: every rank holds it whole; the smoke
    # config's own sorted dispatch at capacity factor 1.25, which drops rows
    "serve-moe-b3": ("qwen3-moe-30b-a3b", {"batch": 3}, "seq"),
}
GENERATE_CASE = "serve-llama"  # also driven through launch.serve.generate(mesh=)
REPLICATED_CASE = "serve-moe-b3"  # also through generate(mesh=)
VARIANTS = ("bf16", "f32")  # the caches' dtype (Mamba's state is float32 in both)
STORED_CASES = tuple(CASES)
POOL_CASES = tuple(CASES)
POOL_MESH = {k: "2x4" for k in CASES}


def case_rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def batch_of(name: str) -> int:
    return CASES[name][1].get("batch", B)


def case_cfg(get_config, name: str):
    """The case's smoke config on mesh axes ("data", "model") (either
    package's ``get_config``); a ``sorted_ep`` MoE at capacity factor E/k,
    so that no chunk drops a row."""
    arch, change, _ = CASES[name]
    cfg = dc.replace(get_config(arch, smoke=True), mesh_axes=MESH[1])
    if "kv_dup" in change:
        cfg = dc.replace(cfg, kv_dup=change["kv_dup"])
    if "dispatch" in change:
        m = cfg.moe
        cfg = dc.replace(cfg, moe=dc.replace(m, dispatch=change["dispatch"],
                                             capacity_factor=m.num_experts / m.top_k))
    return cfg


def inputs(name: str) -> dict:
    """The case's NumPy inputs: the weights as the reference's parameter tree
    under ``"tree"``, the prompts (B, S) ids, or for a front-end stub (B, S,
    D) embeddings drawn as the serve driver draws them (a seeded (V, D)
    table at 0.02), and the forced tokens (B, STEPS); B the case's batch."""
    from repro.configs import get_config as j_get_config
    from test_torch_families import family_weights

    rng = case_rng(name)
    cfg = j_get_config(CASES[name][0], smoke=True)
    tree = family_weights(cfg, rng)
    b = batch_of(name)
    prompts = rng.integers(0, cfg.vocab, (b, S)).astype(np.int32)
    if cfg.frontend_stub:
        table = (0.02 * rng.standard_normal((cfg.vocab, cfg.d_model))).astype(np.float32)
        prompts = table[prompts]
    return dict(tree=tree, prompts=prompts,
                force=rng.integers(0, cfg.vocab, (b, STEPS)).astype(np.int32))


def mrope_pos(b: int, start: int, length: int) -> np.ndarray:
    return np.broadcast_to(np.arange(start, start + length, dtype=np.int32),
                           (3, b, length)).copy()


def flat_caches(tree, prefix: str = "") -> dict:
    """A cache tree (dicts, pairs of dicts) by ``/``-joined path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_caches(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)) and tree and all(isinstance(t, dict) for t in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_caches(v, f"{prefix}{i}/"))
        return out
    return {prefix.rstrip("/"): tree}


# ---------------------------------------------------------------------------
# the reference (JAX, 8 host devices, meshes of Auto axes)
# ---------------------------------------------------------------------------


def compute(name: str) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    import repro.distributed._compat as compat
    from repro.configs import get_config as j_get_config
    from repro.distributed import moe_parallel as JMP
    from repro.distributed import sharding as JSH
    from repro.launch import steps as JST
    from repro.models import model as JM

    compat._CHECK_DEFAULT = False  # the EP block as written (check_vma rejects it)
    shape, axes = MESH
    mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    JMP.set_current_mesh(mesh)
    cfg = case_cfg(j_get_config, name)
    inp = inputs(name)
    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731

    def named(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree, is_leaf=is_spec)

    b = batch_of(name)
    split = b % shape[0] == 0  # else replicated, as the reference's batch_shardings

    def batch_spec(ndim, **kw):
        return JSH.batch_spec(mesh, ndim, **kw) if split else PartitionSpec()

    _, logical = JST.abstract_init(cfg)
    psh = named(JSH.tree_specs(logical, JSH.rules_for_mesh(mesh)))
    cspecs = JSH.cache_specs(cfg, mesh)
    if not split:  # the caches' batch axis (after the layers') replicated
        cspecs = jax.tree.map(lambda s: PartitionSpec(*(None if i == 1 else a
                                                        for i, a in enumerate(s))),
                              cspecs, is_leaf=is_spec)
    csh = named(cspecs)
    prompts = jnp.asarray(inp["prompts"])
    bsh = {"tokens": NamedSharding(mesh, batch_spec(prompts.ndim))}
    batch = {"tokens": prompts}
    dsh = {"token": NamedSharding(mesh, batch_spec(2)), "caches": csh}
    mrope = cfg.rope == "mrope"
    if mrope:
        batch["mrope_pos"] = jnp.asarray(mrope_pos(b, 0, S))
        bsh["mrope_pos"] = dsh["mrope_pos"] = NamedSharding(mesh, batch_spec(3, batch_axis=1))

    def prefill_f32(params, batch):  # the reference's prefill step, float32 caches
        caches = JM.init_cache(cfg, batch["tokens"].shape[0], MAX_LEN, dtype=jnp.float32)
        logits, new, _ = JM.forward(params, cfg, batch["tokens"], caches=caches,
                                    mrope_pos=batch.get("mrope_pos"))
        return logits[:, -1:], new

    def decode_f32(params, batch):
        return JM.decode_step(params, cfg, batch["token"], batch["caches"],
                              mrope_pos=batch.get("mrope_pos"))

    steps = {"bf16": (JST.make_prefill_step(cfg, MAX_LEN), JST.make_serve_step(cfg)),
             "f32": (prefill_f32, decode_f32)}
    out = {}
    devices = np.asarray(mesh.devices)
    for variant in VARIANTS:
        with mesh:
            params = jax.device_put(jax.tree.map(jnp.asarray, inp["tree"]), psh)
            prefill = jax.jit(steps[variant][0], in_shardings=(psh, bsh),
                              out_shardings=(None, csh))
            decode = jax.jit(steps[variant][1], in_shardings=(psh, dsh),
                             out_shardings=(None, csh))
            logits, caches = prefill(params, jax.device_put(batch, bsh))
            kept = [logits[:, -1]]
            for i in range(STEPS):
                step = {"token": jnp.asarray(inp["force"][:, i:i + 1]), "caches": caches}
                if mrope:
                    step["mrope_pos"] = jnp.asarray(mrope_pos(b, S + i, 1))
                logits, caches = decode(params, jax.device_put(step, dsh))
                kept.append(logits[:, -1])
        out[f"{variant}/logits"] = np.stack([np.asarray(v, np.float32) for v in kept], 1)
        for path, leaf in flat_caches(caches).items():
            key = f"{variant}/{path}"
            if path.endswith("index"):
                out[key] = np.asarray(leaf)
                continue
            for shard in leaf.addressable_shards:
                d, m = (int(c) for c in np.argwhere(devices == shard.device)[0])
                out[f"{key}@{d},{m}"] = np.asarray(shard.data, np.float32)  # bf16 exactly
            out[f"{key}#shape"] = np.asarray(leaf.sharding.shard_shape(leaf.shape))
    return out


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def port(name: str, mesh, inp: dict, workdir: str) -> dict:
    """The case on this rank of ``mesh`` (CPU ranks, the plain versions):
    the model sharded by the logical-axis rules, ``bf16`` through the
    prefill and decode steps of ``launch.steps`` (given the global batch),
    ``f32`` through ``model.forward`` / ``decode_step`` on float32 caches
    of ``init_cache(..., mesh=)`` as the steps run them: on the rank's data
    shard, the logits all-gathered over the data ranks, or on the whole
    batch where it does not divide them (``fsdp.whole_batch``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M

    cfg = case_cfg(get_config, name)
    model = M.params_from_numpy(cfg, inp["tree"], device="cpu", mesh=mesh, sharded=True)
    prompts = torch.from_numpy(np.array(inp["prompts"]))
    b = batch_of(name)
    dp = mesh.sub("data")
    split = b % dp.world == 0

    def mine(batch):
        return ST.local_batch(batch, mesh) if split else batch

    def whole(t):
        return SH.all_gather(dp, t).flatten(0, 1) if split else t

    def prefill_f32(params, batch):
        batch = mine(batch)
        caches = M.init_cache(cfg, batch["tokens"].shape[0], MAX_LEN, torch.float32,
                              device="cpu", mesh=mesh)
        with torch.inference_mode(), FS.whole_batch(params, not split):
            logits, new, _ = M.forward(params, cfg, batch["tokens"], caches=caches,
                                       mrope_pos=batch.get("mrope_pos"), backend="torch",
                                       mesh=mesh)
        return whole(logits[:, -1:]), new

    def decode_f32(params, batch):
        caches = batch["caches"]
        batch = mine({k: v for k, v in batch.items() if k != "caches"})
        with torch.inference_mode(), FS.whole_batch(params, not split):
            logits, new = M.decode_step(params, cfg, batch["token"], caches,
                                        mrope_pos=batch.get("mrope_pos"), backend="torch",
                                        mesh=mesh)
        return whole(logits), new

    steps = {"bf16": (ST.make_prefill_step(cfg, MAX_LEN, mesh=mesh, backend="torch"),
                      ST.make_serve_step(cfg, mesh=mesh, backend="torch")),
             "f32": (prefill_f32, decode_f32)}
    mrope = cfg.rope == "mrope"
    out = dict(coords=dict(mesh.coords))
    for variant in VARIANTS:
        before = dict(SH.COLLECTIVES)
        prefill, decode = steps[variant]
        batch = {"tokens": prompts}
        if mrope:
            batch["mrope_pos"] = torch.from_numpy(mrope_pos(b, 0, S))
        logits, caches = prefill(model, batch)
        kept = [logits[:, -1].numpy().copy()]
        for i in range(STEPS):
            step = {"token": torch.from_numpy(inp["force"][:, i:i + 1].astype(np.int64))}
            if mrope:
                step["mrope_pos"] = torch.from_numpy(mrope_pos(b, S + i, 1))
            logits, caches = decode(model, dict(step, caches=caches))
            kept.append(logits[:, -1].numpy().copy())
        out[variant] = dict(
            logits=np.stack(kept, 1),
            collectives={k: SH.COLLECTIVES[k] - before[k] for k in SH.KINDS},
            caches={k: v.float().numpy().copy() for k, v in flat_caches(caches).items()})
    if name in (GENERATE_CASE, REPLICATED_CASE):
        from repro_torch.launch.serve import generate

        force = torch.from_numpy(inp["force"].astype(np.int64))
        gen = generate(model, cfg, prompts, gen=STEPS + 1, max_len=MAX_LEN, backend="torch",
                       force=force, keep_logits=True, mesh=mesh)
        out.update(generate_logits=gen.logits, generate_tokens=gen.tokens)
    return out


def card_rank_main(rank: int, world: int, rdv: str, out) -> None:
    """A rank of ``tests/test_torch_cuda.py``'s sharded-serve test: ranks
    sharing the card over gloo on mesh (1, world) serve the qwen3-moe smoke
    config in float32 (``sorted_ep`` at capacity factor E/k, every leaf
    sharded, the caches split by KV heads over the model ranks) through
    ``launch.serve.generate(mesh=)``, with the kernels and with the plain
    versions, teacher-forced; rank 0 also serves one process's model from
    the same draw.  Puts ``(rank, result or traceback)`` on ``out``."""
    import traceback

    import torch

    try:
        from repro_torch.configs import get_config
        from repro_torch.distributed import sharding as SH
        from repro_torch.kernels import ops
        from repro_torch.launch.serve import generate
        from repro_torch.models import model as M

        torch.backends.cuda.matmul.allow_tf32 = False
        SH.init_distributed(backend="gloo", num_processes=world, process_id=rank,
                            init_method=f"file://{rdv}", timeout_s=120)
        dev = torch.device("cuda", 0)
        mesh = SH.make_mesh((1, world), MESH[1], device=dev)
        cfg = case_cfg(get_config, "serve-moe")
        rng = case_rng("card-serve")
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
        force = torch.from_numpy(rng.integers(0, cfg.vocab, (B, STEPS)))
        kw = dict(gen=STEPS + 1, max_len=MAX_LEN, force=force, keep_logits=True)
        model = M.init(cfg, torch.Generator(device=dev).manual_seed(1), mesh=mesh, sharded=True)
        res = {}
        for backend in ("cuda", "torch"):
            ops.reset_launch_counts()
            got = generate(model, cfg, prompts, backend=backend, mesh=mesh, **kw)
            res[backend] = dict(logits=got.logits, launches=dict(ops.LAUNCHES))
        if rank == 0:
            plain = dc.replace(cfg, mesh_axes=None,
                               moe=dc.replace(cfg.moe, dispatch="sorted"))
            one = M.init(plain, torch.Generator(device=dev).manual_seed(1))
            res["one process"] = dict(logits=generate(one, plain, prompts, backend="cuda",
                                                      **kw).logits)
        out.put((rank, res))
        torch.distributed.destroy_process_group()
    except Exception:  # noqa: BLE001  (reported to the test, which fails)
        out.put((rank, traceback.format_exc()))

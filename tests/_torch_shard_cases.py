"""The cases of ``tests/test_torch_shard.py``: the mesh paths of the port
run by one process a rank (``port(name, mesh)``) and the reference's
mesh programs over fake host devices (``reference(name)``).

The port's side imports nothing of JAX, so the test's spawned ranks load
only this module, PyTorch and the port.  ``reference`` imports JAX and
the JAX package lazily; ``scripts/make_torch_shard_reference.py`` runs it
with ``--xla_force_host_platform_device_count=4`` and stores the results.

A reference result holds the global arrays of the reference's mesh
programs; :func:`shard` cuts every state of it into the ``world`` equal
shards the devices held, which rank ``r`` of the port must equal.
"""
from __future__ import annotations

import json

import numpy as np

FIELDS = ("keys", "count", "sum", "min", "max")
CFG = dict(memory_rows=256, page_rows=32, fanin=4, batch_rows=64)
N = 4096
VOCAB = 1000  # the sparse-embedding case's token space
POLICIES = ("traditional", "inrun_dedup", "early_agg", "rs")
U32, U64 = np.dtype(np.uint32), np.dtype(np.uint64)

CASES: dict[str, dict] = {}
for _policy in POLICIES:
    for _kd in (U32, U64):
        CASES[f"oneshot-{_policy}-{_kd.name}-w4"] = dict(kind="oneshot", policy=_policy,
                                                         kd=_kd, world=4)
CASES["oneshot-rs-uint32-w2"] = dict(kind="oneshot", policy="rs", kd=U32, world=2)
CASES["oneshot-early_agg-uint64-w2"] = dict(kind="oneshot", policy="early_agg", kd=U64,
                                            world=2)
CASES["oneshot-rs-uint32-w1"] = dict(kind="oneshot", policy="rs", kd=U32, world=1)
CASES["zipf-rs-uint32-w4"] = dict(kind="zipf", policy="rs", kd=U32, world=4)
CASES["zipf-traditional-uint64-w4"] = dict(kind="zipf", policy="traditional", kd=U64, world=4)
CASES["groupby-w4"] = dict(kind="groupby", world=4)
CASES["groupby-w2"] = dict(kind="groupby", world=2)
CASES["sparse_embedding-w4"] = dict(kind="sparse_embedding", world=4)
CASES["groupby-overflow-w4"] = dict(kind="groupby_overflow", world=4)
CASES["retry-w2"] = dict(kind="retry", world=2)
CASES["hotkey-w4"] = dict(kind="hotkey", world=4)
CASES["edges-w4"] = dict(kind="edges", world=4)
CASES["exchange-edge-w2"] = dict(kind="exchange_edge", world=2)
CASES["join-w4"] = dict(kind="join", world=4)
CASES["stream-w4"] = dict(kind="stream", world=4)
CASES["service-w4"] = dict(kind="service", world=4)
CASES["frontdoor-w4"] = dict(kind="frontdoor", world=4)


def case_rng(name: str):
    return np.random.default_rng(sorted(CASES).index(name))


def _keys(rng, n, domain, kd):
    keys = rng.integers(0, domain, n).astype(kd)
    return keys << np.uint64(30) if kd == U64 else keys


def _zipf(rng, n, domain, s):
    p = np.arange(1, domain + 1, dtype=np.float64) ** -float(s)
    return rng.choice(domain, size=n, p=p / p.sum())


def inputs(name: str) -> dict:
    """The case's global input arrays (both packages draw the same)."""
    c, rng = CASES[name], case_rng(name)
    kind = c["kind"]
    if kind == "oneshot":
        return dict(keys=_keys(rng, N, 1200, c["kd"]),
                    pay=rng.normal(size=(N, 1)).astype(np.float32))
    if kind == "zipf":
        keys = _zipf(rng, 8192, 2048, 1.2).astype(c["kd"])
        if c["kd"] == U64:
            keys = keys << np.uint64(30)
        return dict(keys=keys, pay=rng.normal(size=(8192, 1)).astype(np.float32))
    if kind in ("groupby", "groupby_overflow"):
        n = 4 * 4096
        return dict(keys=rng.integers(0, 700, n).astype(np.uint32),
                    pay=rng.normal(size=(n, 2)).astype(np.float32),
                    uniq=np.arange(n, dtype=np.uint32))
    if kind == "sparse_embedding":
        return dict(tokens=rng.integers(0, VOCAB, N).astype(np.uint32),
                    grads=rng.normal(size=(N, 8)).astype(np.float32))
    if kind == "retry":
        return dict(keys=np.arange(512, dtype=np.uint32), pay=np.ones((512, 1), np.float32))
    if kind == "hotkey":
        keys = rng.integers(0, 700, N).astype(np.uint32)
        keys[rng.permutation(N)[: int(N * 0.6)]] = 350
        return dict(keys=keys, pay=rng.normal(size=(N, 1)).astype(np.float32))
    if kind == "edges":
        return dict(odd=rng.integers(0, 900, 4001).astype(np.uint32),
                    hot=np.full(12000, 7, np.uint32),
                    band=(rng.integers(0, 500, 4096) + (1 << 31)).astype(np.uint32),
                    band_pay=rng.normal(size=(4096, 2)).astype(np.float32))
    if kind == "join":
        n = 600
        out = {}
        for side, seed, lo, hi in (("l", 1, 0, 12), ("r", 2, 6, 18)):
            r = np.random.default_rng(seed)
            out[f"{side}_region"] = r.integers(0, 4, n)
            out[f"{side}_store"] = r.integers(lo, hi, n)
            out[f"{side}_vals"] = r.normal(size=n).astype(np.float32)
        return out
    if kind in ("stream", "service"):
        return dict(keys=rng.integers(0, 1200, 8192).astype(np.uint32),
                    pay=rng.normal(size=(8192, 1)).astype(np.float32))
    if kind == "frontdoor":
        return dict(keys=rng.integers(0, 1200, N).astype(np.uint32),
                    pay=rng.normal(size=(N, 1)).astype(np.float32))
    return {}


# the exchange-edge case: (local keys of shard 0, of shard 1, capacity,
# quota, inner cut)
EXCHANGE_EDGES = (([3, 900000], [], 4, 1, 1000),
                  ([10, 11, 12], [13, 14, 15], 4, 2, 1 << 20),
                  ([10, 11, 12], [13, 14, 15], 4, 4, 1 << 20))


# ---------------------------------------------------------------------------
# result <-> arrays
# ---------------------------------------------------------------------------


def np_state(st) -> dict[str, np.ndarray]:
    if type(st.keys).__module__.startswith("torch"):
        from repro_torch.core.types import state_to_numpy

        return state_to_numpy(st)
    return {f: np.asarray(getattr(st, f)) for f in FIELDS}


def to_arrays(name: str, result: dict) -> dict[str, np.ndarray]:
    out, host = {}, {}
    for entry, v in result.items():
        if isinstance(v, dict) and v and all(isinstance(x, np.ndarray) for x in v.values()):
            for f, arr in v.items():
                out[f"{name}|{entry}|{f}"] = arr
        elif isinstance(v, np.ndarray):
            out[f"{name}|{entry}"] = v
        else:
            host[entry] = v
    out[f"{name}|host"] = np.asarray(json.dumps(host, sort_keys=True))
    return out


def from_arrays(name: str, arrays) -> dict:
    result = json.loads(str(arrays[f"{name}|host"]))
    for key in arrays.files if hasattr(arrays, "files") else arrays:
        parts = key.split("|")
        if parts[0] != name or parts[1] == "host":
            continue
        if len(parts) == 2:
            result[parts[1]] = arrays[key]
        else:
            result.setdefault(parts[1], {})[parts[2]] = arrays[key]
    return result


def shard(result: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s part of a reference result: every state cut into
    ``world`` equal shards; host values as they are (the reference's are
    replicated).  Entries named ``*whole`` are relations every rank
    holds whole."""
    out = {}
    for entry, v in result.items():
        if isinstance(v, dict) and set(v) == set(FIELDS) and not entry.endswith("whole"):
            v = {f: np.split(a, world)[rank] for f, a in v.items()}
        out[entry] = v
    return out


def _stats(stats) -> dict:
    return stats.as_dict()


def _rel(rel: dict) -> dict:
    return {k: np.asarray(v) for k, v in rel.items()}


# ---------------------------------------------------------------------------
# the port: one rank's part
# ---------------------------------------------------------------------------


def port(name: str, mesh, device: str = "cpu") -> dict:
    """Run case ``name`` on this rank of ``mesh``."""
    import torch

    import repro_torch
    from repro_torch.core import pipeline
    from repro_torch.core.operators import group_by
    from repro_torch.core.types import ExecConfig, state_from_numpy
    from repro_torch.distributed import groupby as gb
    from repro_torch.distributed.sharding import local_slice
    from repro_torch.service import AggregationService

    c, x = CASES[name], inputs(name)
    kind, cfg = c["kind"], ExecConfig(**CFG)
    dev = device
    out: dict = {}

    def sl(a):
        return local_slice(a, mesh)

    if kind in ("oneshot", "zipf", "hotkey"):
        policies = ("rs", "early_agg") if kind == "hotkey" else (c["policy"],)
        for policy in policies:
            st, stats = pipeline.insort_aggregate_device(
                sl(x["keys"]), sl(x["pay"]), cfg, policy=policy, mesh=mesh, device=dev)
            out[f"state_{policy}"] = np_state(st)
            out[f"stats_{policy}"] = _stats(stats)
        if kind == "oneshot" and c["world"] > 1:
            # the stats equal the per-shard single-device runs reduced, but
            # for the exchange's own fields (the reference's _PARITY)
            mine = pipeline.insort_aggregate_device(sl(x["keys"]), sl(x["pay"]), cfg,
                                                    policy=c["policy"], device=dev)[1]
            out["local_stats"] = _stats(mine)
    elif kind == "groupby":
        fn = gb.make_distributed_groupby(mesh, "data", capacity=4096, device=dev)
        out["state"] = np_state(fn(sl(x["keys"]), sl(x["pay"])))
    elif kind == "sparse_embedding":
        out["state"] = np_state(gb.sparse_embedding_grad(
            sl(x["tokens"]), torch.from_numpy(sl(x["grads"])), VOCAB, mesh, "data"))
    elif kind == "groupby_overflow":
        fn = gb.make_distributed_groupby(mesh, "data", capacity=256, device=dev)
        try:
            fn(sl(x["keys"]), sl(x["pay"]))
            out["raised"] = ""
        except RuntimeError as e:
            out["raised"] = "dropped rows" if "dropped rows" in str(e) else str(e)
        for tag, cap, keys in (("small", 256, x["keys"]), ("wide", 4096, x["keys"]),
                               ("uniq", 1024, x["uniq"])):
            fn = gb.make_distributed_groupby(mesh, "data", capacity=cap, on_overflow="flag",
                                             device=dev)
            _, flag = fn(sl(keys), sl(x["pay"]))
            out[f"flag_{tag}"] = bool(flag)
    elif kind == "retry":
        cfg2 = ExecConfig(memory_rows=512, page_rows=32, fanin=4, batch_rows=64)
        st, stats = pipeline.insort_aggregate_device(
            sl(x["keys"]), sl(x["pay"]), cfg2, policy="rs", mesh=mesh, exchange_quota=128,
            device=dev)
        out["state"], out["stats"] = np_state(st), _stats(stats)
    elif kind == "edges":
        st, stats = pipeline.insort_aggregate_device(np.zeros(0, np.uint32), None, cfg,
                                                     mesh=mesh, device=dev)
        out["empty_state"], out["empty_stats"] = np_state(st), _stats(stats)
        for tag, keys, pay, kw in (
                ("odd", x["odd"], None, dict(policy="early_agg")),
                ("hot", x["hot"], None, dict(policy="rs")),
                ("band", x["band"], x["band_pay"], dict(policy="rs")),
                ("band_widths", x["band"], x["band_pay"], dict(policy="rs",
                                                              widths=(2, 0, 0)))):
            st, stats = pipeline.insort_aggregate_device(
                sl(keys), None if pay is None else sl(pay), cfg, mesh=mesh, device=dev, **kw)
            out[f"{tag}_state"], out[f"{tag}_stats"] = np_state(st), _stats(stats)
    elif kind == "exchange_edge":
        for i, (ka, kb, cap, quota, cut) in enumerate(EXCHANGE_EDGES):
            local = _edge_state((ka, kb)[mesh.rank], cap)
            st = state_from_numpy(local, device=dev)
            inner = torch.tensor([cut], dtype=torch.int64, device=dev)
            recv, sent, dropped, fill = gb.exchange_sorted_fragments(st, mesh, quota=quota,
                                                                    inner_cuts=inner)
            (sent,), (dropped, fill) = gb.reduce_flags(mesh, (sent,), (dropped, fill))
            out[f"recv{i}"] = np_state(recv)
            out[f"flags{i}"] = [int(sent), int(dropped), int(fill)]
    elif kind == "join":
        spec = repro_torch.KeySpec.of(region=6, store=8)

        def rel(side):
            return repro_torch.aggregate(
                {"region": x[f"{side}_region"], "store": x[f"{side}_store"]}, by=spec,
                values=x[f"{side}_vals"], aggs=("count", "sum"), output_estimate=256,
                device=dev)

        L, R = rel("l"), rel("r")
        J = L.merge_join(R, mesh=mesh, mesh_axis="data")
        out["left"], out["right"] = np_state(J.left), np_state(J.right)
        out["products"] = np_state(J.products)
        out["stats"] = _stats(J.stats)
        out["plan_mesh"] = {k: v for k, v in J.plan["mesh"].items()}
        out["relation"] = _rel(J.relation())
        out["rollup"] = _rel(J.rollup(levels=[0])[()].relation())
        for how in ("semi", "anti"):
            H = L.merge_join(R, how=how, mesh=mesh, mesh_axis="data")
            out[f"{how}_left"], out[f"{how}_stats"] = np_state(H.left), _stats(H.stats)
            out[f"{how}_relation"] = _rel(H.relation())
    elif kind == "stream":
        def chunks():
            for s in range(0, 8192, 2048):
                yield x["keys"][s:s + 2048], x["pay"][s:s + 2048]

        st, stats = pipeline.insort_aggregate_device_stream(chunks(), cfg, policy="rs",
                                                           mesh=mesh, device=dev)
        out["state"], out["stats"] = np_state(st), _stats(stats)
    elif kind == "service":
        svc = AggregationService(cfg, policy="rs", key_dtype=np.uint32, width=1,
                                 output_rows=8192, mesh=mesh, device=dev)
        for s in range(0, 8192, 2048):
            svc.ingest(x["keys"][s:s + 2048], x["pay"][s:s + 2048])
        svc.flush()
        es = svc._agg._es
        tensors = [getattr(s_, f) for s_ in (es.store, es.table, es.table2) for f in FIELDS]
        tensors.append(es.frontier)
        before = [t.clone() for t in tensors]
        st, stats = svc.snapshot()
        out["unchanged"] = all(torch.equal(b, t) for b, t in zip(before, tensors))
        out["snap_state"], out["snap_stats"] = np_state(st), _stats(stats)
        out["retired"] = svc.retire_below(600)
        st, stats = svc.snapshot()
        out["evict_state"], out["evict_stats"] = np_state(st), _stats(stats)
        svc.ingest(x["keys"][:2048], x["pay"][:2048])
        st, stats = svc.close()
        out["close_state"], out["close_stats"] = np_state(st), _stats(stats)
        m = svc.metrics.summary()
        out["metrics"] = {k: m[k] for k in ("rows_ingested", "snapshots_taken", "rows_retired",
                                            "groups_last_snapshot") if k in m}
    elif kind == "frontdoor":
        res = repro_torch.aggregate({"k": sl(x["keys"])}, by=repro_torch.KeySpec.of(k=12),
                                    values=sl(x["pay"]), aggs=("count", "sum"), cfg=cfg,
                                    order_by=True, mesh=mesh, device=dev)
        out["state"], out["stats"] = np_state(res.state), _stats(res.stats)
        out["plan_mesh"] = res.plan["mesh"]
        out["relation_whole"] = _rel(res.relation())
        st, stats = group_by(sl(x["keys"]), sl(x["pay"]), cfg, mesh=mesh, device=dev)
        out["group_by_state"], out["group_by_stats"] = np_state(st), _stats(stats)
        raised = []
        for label, call in (
                ("hash", lambda: repro_torch.aggregate(
                    {"k": sl(x["keys"])}, by=repro_torch.KeySpec.of(k=12), cfg=cfg,
                    algorithm="hash", mesh=mesh, device=dev)),
                ("host", lambda: group_by(sl(x["keys"]), sl(x["pay"]), cfg, pipeline="host",
                                          mesh=mesh, device=dev)),
                ("adaptive", lambda: pipeline.StreamingAggregator(
                    cfg, policy="adaptive", mesh=mesh, device=dev)),
                ("governor", lambda: pipeline.StreamingAggregator(
                    cfg, policy="rs", governor=object(), mesh=mesh, device=dev))):
            try:
                call()
                raised.append(f"{label}: no error")
            except ValueError:
                raised.append(f"{label}: ValueError")
        out["raised"] = raised
    return out


def _edge_state(keys, capacity: int) -> dict[str, np.ndarray]:
    """A sorted, duplicate-free, EMPTY-padded uint32 state of width 1 (the
    reference test's ``mk``)."""
    k = np.full(capacity, 0xFFFFFFFF, np.uint32)
    k[:len(keys)] = np.sort(np.asarray(keys, np.uint32))
    return dict(keys=k, count=(k != 0xFFFFFFFF).astype(np.int32),
                sum=np.zeros((capacity, 1), np.float32),
                min=np.full((capacity, 1), np.inf, np.float32),
                max=np.full((capacity, 1), -np.inf, np.float32))


# ---------------------------------------------------------------------------
# the reference: the global program over fake host devices
# ---------------------------------------------------------------------------


def reference(name: str) -> dict:
    """Run case ``name`` through the JAX package on a mesh of the case's
    world over the host devices (``--xla_force_host_platform_device_count``
    at least 4).  Every state is the global array."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import repro
    from repro.core import pipeline
    from repro.core.operators import group_by
    from repro.core.types import ExecConfig, empty_state
    from repro.distributed import groupby as gb
    from repro.distributed._compat import shard_map
    from repro.service import AggregationService

    c, x = CASES[name], inputs(name)
    kind, cfg = c["kind"], ExecConfig(**CFG)
    # a mesh of Auto axes: the mesh merge join's eager shard_map fails on
    # jax.make_mesh's Explicit axes under the installed JAX
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:c["world"]]), ("data",))
    out: dict = {}

    if kind in ("oneshot", "zipf", "hotkey"):
        policies = ("rs", "early_agg") if kind == "hotkey" else (c["policy"],)
        for policy in policies:
            st, stats = pipeline.insort_aggregate_device(x["keys"], x["pay"], cfg,
                                                         policy=policy, mesh=mesh)
            out[f"state_{policy}"] = np_state(st)
            out[f"stats_{policy}"] = _stats(stats)
    elif kind == "groupby":
        fn = gb.make_distributed_groupby(mesh, "data", capacity=4096)
        with mesh:
            out["state"] = np_state(fn(jnp.asarray(x["keys"]), jnp.asarray(x["pay"])))
    elif kind == "sparse_embedding":
        with mesh:
            out["state"] = np_state(gb.sparse_embedding_grad(
                jnp.asarray(x["tokens"]), jnp.asarray(x["grads"]), VOCAB, mesh, "data"))
    elif kind == "groupby_overflow":
        fn = gb.make_distributed_groupby(mesh, "data", capacity=256)
        try:
            with mesh:
                fn(jnp.asarray(x["keys"]), jnp.asarray(x["pay"]))
            out["raised"] = ""
        except RuntimeError as e:
            out["raised"] = "dropped rows" if "dropped rows" in str(e) else str(e)
        for tag, cap, keys in (("small", 256, x["keys"]), ("wide", 4096, x["keys"]),
                               ("uniq", 1024, x["uniq"])):
            fn = gb.make_distributed_groupby(mesh, "data", capacity=cap, on_overflow="flag")
            with mesh:
                _, flag = fn(jnp.asarray(keys), jnp.asarray(x["pay"]))
            out[f"flag_{tag}"] = bool(flag)
    elif kind == "retry":
        cfg2 = ExecConfig(memory_rows=512, page_rows=32, fanin=4, batch_rows=64)
        st, stats = pipeline.insort_aggregate_device(x["keys"], x["pay"], cfg2, policy="rs",
                                                     mesh=mesh, exchange_quota=128)
        out["state"], out["stats"] = np_state(st), _stats(stats)
    elif kind == "edges":
        st, stats = pipeline.insort_aggregate_device(np.zeros(0, np.uint32), None, cfg,
                                                     mesh=mesh)
        out["empty_state"], out["empty_stats"] = np_state(st), _stats(stats)
        for tag, keys, pay, kw in (
                ("odd", x["odd"], None, dict(policy="early_agg")),
                ("hot", x["hot"], None, dict(policy="rs")),
                ("band", x["band"], x["band_pay"], dict(policy="rs")),
                ("band_widths", x["band"], x["band_pay"], dict(policy="rs",
                                                              widths=(2, 0, 0)))):
            st, stats = pipeline.insort_aggregate_device(keys, pay, cfg, mesh=mesh, **kw)
            out[f"{tag}_state"], out[f"{tag}_stats"] = np_state(st), _stats(stats)
    elif kind == "exchange_edge":
        import dataclasses

        for i, (ka, kb, cap, quota, cut) in enumerate(EXCHANGE_EDGES):
            a, b = _edge_state(ka, cap), _edge_state(kb, cap)
            stacked = dataclasses.replace(
                empty_state(2 * cap, 1), **{f: jnp.asarray(np.concatenate([a[f], b[f]]))
                                            for f in FIELDS})
            inner = jnp.asarray([cut], jnp.uint32)

            def f(st, quota=quota, inner=inner):
                recv, sent, dropped, fill = gb.exchange_sorted_fragments(
                    st, "data", 2, quota=quota, inner_cuts=inner)
                return (recv, jax.lax.psum(sent, "data"), jax.lax.pmax(dropped, "data"),
                        jax.lax.pmax(fill, "data"))

            fn = shard_map(f, mesh=mesh, in_specs=(P("data"),),
                           out_specs=(P("data"), P(), P(), P()))
            recv, sent, dropped, fill = fn(stacked)
            out[f"recv{i}"] = np_state(recv)
            out[f"flags{i}"] = [int(sent), int(dropped), int(fill)]
    elif kind == "join":
        spec = repro.KeySpec.of(region=6, store=8)

        def rel(side):
            return repro.aggregate(
                {"region": x[f"{side}_region"], "store": x[f"{side}_store"]}, by=spec,
                values=x[f"{side}_vals"], aggs=("count", "sum"), output_estimate=256)

        L, R = rel("l"), rel("r")
        with mesh:
            J = L.merge_join(R, mesh=mesh, mesh_axis="data")
        out["left"], out["right"] = np_state(J.left), np_state(J.right)
        out["products"] = np_state(J.products)
        out["stats"] = _stats(J.stats)
        out["plan_mesh"] = {k: v for k, v in J.plan["mesh"].items()}
        out["relation"] = _rel(J.relation())
        out["rollup"] = _rel(J.rollup(levels=[0])[()].relation())
        for how in ("semi", "anti"):
            with mesh:
                H = L.merge_join(R, how=how, mesh=mesh, mesh_axis="data")
            out[f"{how}_left"], out[f"{how}_stats"] = np_state(H.left), _stats(H.stats)
            out[f"{how}_relation"] = _rel(H.relation())
    elif kind == "stream":
        def chunks():
            for s in range(0, 8192, 2048):
                yield x["keys"][s:s + 2048], x["pay"][s:s + 2048]

        st, stats = pipeline.insort_aggregate_device_stream(chunks(), cfg, policy="rs",
                                                           mesh=mesh)
        out["state"], out["stats"] = np_state(st), _stats(stats)
    elif kind == "service":
        svc = AggregationService(cfg, policy="rs", key_dtype=np.uint32, width=1,
                                 output_rows=8192, mesh=mesh)
        for s in range(0, 8192, 2048):
            svc.ingest(x["keys"][s:s + 2048], x["pay"][s:s + 2048])
        st, stats = svc.snapshot()
        out["unchanged"] = True
        out["snap_state"], out["snap_stats"] = np_state(st), _stats(stats)
        out["retired"] = int(svc.retire_below(600))
        st, stats = svc.snapshot()
        out["evict_state"], out["evict_stats"] = np_state(st), _stats(stats)
        svc.ingest(x["keys"][:2048], x["pay"][:2048])
        st, stats = svc.close()
        out["close_state"], out["close_stats"] = np_state(st), _stats(stats)
        m = svc.metrics.summary()
        out["metrics"] = {k: m[k] for k in ("rows_ingested", "snapshots_taken", "rows_retired",
                                            "groups_last_snapshot") if k in m}
    elif kind == "frontdoor":
        res = repro.aggregate({"k": x["keys"]}, by=repro.KeySpec.of(k=12), values=x["pay"],
                              aggs=("count", "sum"), cfg=cfg, order_by=True, mesh=mesh)
        out["state"], out["stats"] = np_state(res.state), _stats(res.stats)
        out["plan_mesh"] = res.plan["mesh"]
        out["relation_whole"] = _rel(res.relation())
        st, stats = group_by(x["keys"], x["pay"], cfg, mesh=mesh)
        out["group_by_state"], out["group_by_stats"] = np_state(st), _stats(stats)
        raised = []
        for label, call in (
                ("hash", lambda: repro.aggregate({"k": x["keys"]}, by=repro.KeySpec.of(k=12),
                                                 cfg=cfg, algorithm="hash", mesh=mesh)),
                ("host", lambda: group_by(x["keys"], x["pay"], cfg, pipeline="host",
                                          mesh=mesh)),
                ("adaptive", lambda: pipeline.StreamingAggregator(cfg, policy="adaptive",
                                                                  mesh=mesh)),
                ("governor", lambda: pipeline.StreamingAggregator(
                    cfg, policy="rs", governor=object(), mesh=mesh))):
            try:
                call()
                raised.append(f"{label}: no error")
            except ValueError:
                raised.append(f"{label}: ValueError")
        out["raised"] = raised
    return out


# ---------------------------------------------------------------------------
# the port's ranks: one process each, fed case names
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, rdv: str, device: str, tasks, results) -> None:
    """A rank of the test pool: join the gloo world at ``rdv``, build the
    world's mesh and the sub-mesh of ranks 0 and 1, then run each case
    name ``tasks`` delivers on the case's mesh and put ``(rank, name,
    status, result)`` on ``results`` (None: stop)."""
    import traceback

    import torch

    from repro_torch.distributed import sharding

    torch.set_num_threads(1)
    sharding.init_distributed(backend="gloo", num_processes=world, process_id=rank,
                              init_method=f"file://{rdv}", timeout_s=120)
    meshes = {world: sharding.data_mesh("data", device=device),
              2: sharding.data_mesh("data", device=device, ranks=[0, 1])}
    while True:
        name = tasks.get()
        if name is None:
            break
        mesh = meshes[CASES[name]["world"]]
        if mesh is None:
            results.put((rank, name, "idle", None))
            continue
        try:
            results.put((rank, name, "ok", port(name, mesh, device=device)))
        except Exception:  # reported to the test, which fails the case
            results.put((rank, name, "error", traceback.format_exc()))

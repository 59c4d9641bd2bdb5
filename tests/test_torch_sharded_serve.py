"""The port's sharded serving held against the JAX package's: the prefill
and decode steps on a data x model mesh (2, 4) of gloo ranks, each rank's
shard of every decode cache, for smoke configs that take the four
routes of a cache over ``"model"``: GQA split by heads (llama3-8b with
``kv_dup`` 2, zamba2's shared block), by sequence with flash-decoding's
combine (the two KV heads of llama3-8b, qwen3-moe through ``sorted_ep``
and qwen2-vl on four ranks), MLA's latent by channels and rotated key by
sequence (deepseek-v3), Mamba's conv channels and SSM heads (mamba2,
zamba2), and a batch that does not divide the data ranks (qwen3-moe's own
``sorted`` dispatch on a batch of 3, held whole by every rank).

The reference's results are computed by
``scripts/make_torch_sharded_serve_reference.py`` (8 host devices, meshes
of ``Auto`` axes) into ``tests/data/torch_sharded_serve_reference.npz``
(``tests/_torch_sharded_serve_cases.py`` says what each case holds).  The
rank cases run on ``tests/test_torch_ep.py``'s pool of 8 gloo ranks.
Each case is served with float32 caches (``f32``) and, through the
steps of ``launch.steps``, with the reference's bfloat16 K/V (``bf16``).
Tolerances: every rank's logits (the global batch's) within 1e-4 of the
reference's largest magnitude, and each rank's cache shard of its exact
shape (GSPMD's) within 1e-4 of the leaf's largest magnitude, for ``f32``;
for ``bf16`` the logits within 2^-8 and the caches within 2^-7, one
bfloat16 ulp at the leaf's largest magnitude (the port's other serve
tests hold bfloat16 caches to 2^-8 likewise): float32 noise of ~1e-7
rounds a K/V entry to the
neighbouring bfloat16 in one package and not in the other (the
one-process port is 1.8e-4 to 8e-4 of the largest logit from the
reference's sharded steps at these inputs); the caches' index equal.
In this process: a rank's cache bytes equal the spec arithmetic for
every architecture on the production meshes, and an empty slice of
positions weighs nothing in the combine.
"""
import functools
import math

import numpy as np
import pytest
import torch

import _torch_sharded_serve_cases as SV
from repro_torch.configs import all_arch_ids, get_config
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as LM
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import model as M
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_ep import pool_results, ranks_of  # noqa: F401  (the session's pool)

TOLS = {"f32": (1e-4, 1e-4), "bf16": (2.0 ** -8, 2.0 ** -7)}  # (logits, caches)


@functools.lru_cache(maxsize=1)
def _stored():
    return np.load(SV.REFERENCE_FILE)


def stored(name: str) -> dict:
    arrays = _stored()
    out = {k.split("|", 1)[1]: arrays[k] for k in arrays.files if k.split("|")[0] == name}
    if not out:
        pytest.fail(f"{SV.REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_sharded_serve_reference.py")
    return out


def within(got, want, scale: float, tol: float, what: str) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(scale, 1e-12) if want.size else 0.0
    assert err <= tol, f"{what}: max |diff| {err} of the largest magnitude > {tol}"
    return err


@pytest.mark.parametrize("variant", SV.VARIANTS)
@pytest.mark.parametrize("name", SV.STORED_CASES)
def test_sharded_serve_equals_reference(name, variant, pool_results):
    """Every rank's logits of the prefill and both decode steps, and its
    shard of every cache leaf (shape exactly, values within the bound), and
    the index."""
    want = {k.split("/", 1)[1]: v for k, v in stored(name).items()
            if k.startswith(variant + "/")}
    tol, cache_tol = TOLS[variant]
    scale = float(np.abs(want["logits"]).max())
    leaves = {k.split("@")[0] for k in want if "@" in k}
    leaf_scale = {leaf: max(float(np.abs(v).max()) for k, v in want.items()
                            if k.split("@")[0] == leaf) for leaf in leaves}
    worst = 0.0
    for rank in ranks_of(pool_results, name):
        got = rank[variant]
        worst = max(worst, within(got["logits"], want["logits"], scale, tol, f"{name} logits"))
        tag = f"@{rank['coords']['data']},{rank['coords']['model']}"
        assert set(got["caches"]) == leaves | {k for k in want if k.endswith("index")}
        for path, shard in got["caches"].items():
            if path.endswith("index"):
                np.testing.assert_array_equal(shard, want[path])
                continue
            assert list(shard.shape) == want[f"{path}#shape"].tolist(), (name, path, tag)
            worst = max(worst, within(shard, want[path + tag], leaf_scale[path], cache_tol,
                                      f"{name} {path}{tag}"))
    print(f"{name} {variant}: largest difference {worst} of the largest magnitude")


ROUTE_COLLECTIVES = {  # the route -> a collective kind its cache path must use
    "seq": "all_reduce", "heads": "all_gather", "mla": "all_gather", "mamba": "all_gather",
    "mamba+heads": "all_gather"}


@pytest.mark.parametrize("name", SV.STORED_CASES)
def test_each_cache_route_runs(name, pool_results):
    """The cache's split is the one the case names: the shard's model
    dimension is a quarter of the global one (padding included), and the
    route's collectives ran."""
    arch, _, route = SV.CASES[name]
    cfg = SV.case_cfg(get_config, name)
    mesh = SH.AbstractMesh.of(*SV.MESH)
    glob = SV.flat_caches(M.init_cache(cfg, SV.batch_of(name), SV.MAX_LEN, device="meta"))
    specs = SV.flat_caches(SH.cache_specs(cfg, mesh))
    if SV.batch_of(name) % mesh.shape["data"]:  # a replicated batch: every rank holds it
        specs = {k: tuple(None if i == 1 else a for i, a in enumerate(v))
                 for k, v in specs.items()}
    for rank in ranks_of(pool_results, name):
        got = rank["bf16"]
        assert got["collectives"][ROUTE_COLLECTIVES[route]] > 0, got["collectives"]
        for path, shard in got["caches"].items():
            if path.endswith("index"):
                continue
            assert shard.shape == SH.shard_shape(glob[path].shape, specs[path], mesh), path
    if route == "seq":
        assert L.kv_split(cfg, mesh) == "seq" and specs["k"][2] == "model"
    if route == "heads":
        assert L.kv_split(cfg, mesh) == "heads" and specs["k"][3] == "model"


def test_generate_on_a_mesh_equals_the_steps(pool_results):
    """``launch.serve.generate(mesh=)`` gives the steps' logits, and the same
    greedy ids on every rank."""
    ranks = ranks_of(pool_results, SV.GENERATE_CASE)
    for got in ranks:
        np.testing.assert_allclose(got["generate_logits"], got["bf16"]["logits"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["generate_tokens"], ranks[0]["generate_tokens"])
        assert got["generate_tokens"].shape == (SV.B, SV.STEPS + 1)


def test_a_replicated_batch_is_routed_whole_on_every_rank(pool_results):
    """A batch of 3 on 2 data ranks is held whole by every rank: a
    ``sorted`` MoE at its own capacity factor (rows dropped) routes it as
    the reference does (``test_sharded_serve_equals_reference``), with no
    gather over the data ranks, and every rank's logits and greedy ids are
    the same, through the steps and through ``generate(mesh=)``."""
    name = SV.REPLICATED_CASE
    cfg = SV.case_cfg(get_config, name)
    assert cfg.moe.dispatch == "sorted" and SV.batch_of(name) % SV.MESH[0][0]
    ranks = ranks_of(pool_results, name)
    first = ranks[0]
    for got in ranks:
        for variant in SV.VARIANTS:
            np.testing.assert_array_equal(got[variant]["logits"], first[variant]["logits"])
            assert got[variant]["logits"].shape[0] == SV.batch_of(name)
        np.testing.assert_allclose(got["generate_logits"], got["bf16"]["logits"], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["generate_tokens"], first["generate_tokens"])


DECODE_ARCHS = [a for a in all_arch_ids() if not ST.shape_skips(get_config(a), "decode_32k")]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_rank_cache_bytes_equal_the_spec_arithmetic(arch, multi_pod):
    """``init_cache(..., mesh=)`` on rank 0 of a production mesh (a
    ``meta_mesh``: nothing allocated) holds exactly the bytes of the global
    ``decode_32k`` caches under ``batch_shardings``' specs."""
    cfg = get_config(arch)
    mesh = SH.meta_mesh(SH.AbstractMesh.of(*LM.production_shape(multi_pod=multi_pod)))
    info = ST.SHAPES["decode_32k"]
    dp = math.prod(mesh.shape[a] for a in SH.DATA_AXES if a in mesh.axis_names)
    mine = SV.flat_caches(M.init_cache(cfg, info["batch"] // dp, info["seq"], device="meta",
                                       mesh=mesh))
    glob = SV.flat_caches(ST.input_specs(cfg, "decode_32k")["caches"])
    specs = SV.flat_caches(ST.batch_shardings(cfg, mesh, "decode_32k")["caches"])
    assert set(mine) == set(glob)
    for path, t in mine.items():
        want = FS.shard_bytes({path: tuple(glob[path].shape)}, specs, mesh,
                              glob[path].element_size())
        assert t.numel() * t.element_size() == want, path


def test_an_empty_slice_of_positions_weighs_nothing():
    """A rank whose positions all lie past the queries (a prompt of 256 on
    the first shard of a long cache) keeps ``m = -inf`` and zero sums, and
    the combine over one rank is the plain softmax."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 3, 2, 8), generator=gen) for _ in range(3))
    m, l, acc = L._partial_softmax(q, k, v, 0, 100, 2)
    assert torch.isinf(m).all() and not l.any() and not acc.any()
    assert not torch.isnan(m).any()
    one = SH.make_mesh((1,), ("model",), device="cpu").sub("model")
    m, l, acc = L._partial_softmax(q, k, v, 5, 0, 2)
    got = L._combine_partials(one, m, l, acc).transpose(1, 2)
    want = L._attn_chunked(q, k, v, causal=True, q_offset=5, chunk_q=3, chunk_k=3)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

"""The port's MoE serve path held against the JAX package's, on the CPU,
with the reference's smoke configuration of ``qwen3-moe-30b-a3b`` (float32,
2 layers) and seeded NumPy weights in the reference's parameter pytree,
carried across with ``params_from_numpy``:

* ``moe_block`` (sorted and dense dispatch, capacity factor 1.0, where rows
  are dropped, and 8.0, where none are), ``attention`` with a cache and
  ``forward``, within rtol/atol 1e-5;
* the prefill step and 4 serve steps, teacher-forced on the same tokens:
  logits within rtol/atol 2e-3 (K/V go through a bfloat16 cache in both),
  equal greedy tokens wherever the top-2 gap exceeds that tolerance;
* the two kernels' plain versions: ``grouped_matmul_plain`` against the
  Pallas ``grouped_matmul`` in interpret mode, and the plain bitonic
  merge-absorb against ``merge_absorb_tiles`` and the reference's
  ``ops.merge_absorb_sorted_bitonic`` (keys and counts equal, planes
  rtol 1e-4).

The reference's model functions run under ``jax.jit`` (one compile each).
Its kernels' results (the grouped matmul and the merge-absorb tiles in
interpret mode, and the bitonic merge-absorb of ``ops``) take seconds a
case, so they are computed for ``STORED_CASES`` by
``scripts/make_torch_moe_reference.py`` from per-case seeded inputs and
read from ``tests/data/torch_moe_reference.npz``;
``test_stored_reference_is_the_reference_output`` recomputes two cases
live.
"""
import dataclasses as dc
import functools
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import sorted_ops as jso
from repro.kernels import ops as kops
from repro.kernels.grouped_matmul import grouped_matmul as j_grouped_matmul
from repro.kernels.merge_aggregate import merge_absorb_tiles
from repro.launch import steps as JST
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.core.ordered_index import argsort_torch, segmented_combine_torch
from repro_torch.core.types import (
    FIELDS,
    AggState,
    concat_states,
    state_from_numpy,
    state_to_numpy,
    take,
)
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import merge_aggregate as ma
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch.serve import generate
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)

ARCH = "qwen3-moe-30b-a3b"
RNG = np.random.default_rng(13)
REFERENCE_FILE = Path(__file__).parent / "data" / "torch_moe_reference.npz"
GMM_SHAPES = [(2, 128, 128, 128, 128), (4, 256, 256, 384, 128), (8, 128, 512, 256, 128),
              (4, 8, 128, 128, 8)]
GMM_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16,
                                                                     torch.bfloat16)}
TILE_SIZES = (64, 256, 1024)
BITONIC_OPS = [(700, 500, 2), (33, 129, 4)]
STORED_CASES = tuple(
    [f"gmm-{dt}-{'-'.join(map(str, shape))}" for shape in GMM_SHAPES for dt in GMM_DTYPES]
    + [f"tiles-{n}" for n in TILE_SIZES]
    + [f"bitonic_ops-{na}-{nb}-{w}" for na, nb, w in BITONIC_OPS])
LIVE_CASES = ("gmm-bfloat16-4-8-128-128-8", "tiles-64")


def case_rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def _j_init(cfg_j, seed):
    """Weights in the reference's parameter pytree (its ``init`` traced for
    shapes only), drawn with NumPy: norm scales near 1, every other leaf
    N(0, 1/fan_in) with fan_in its second-to-last axis."""
    shapes = jax.eval_shape(lambda k: JM.init(cfg_j, k)[0], jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        return (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke config, its weights (seed 0) and the port's
    model holding the same weights."""
    cfg_j = j_get_config(ARCH, smoke=True)
    params = _j_init(cfg_j, 0)
    cfg = get_config(ARCH, smoke=True)
    model = M.params_from_numpy(cfg, params, device="cpu")
    return cfg_j, params, cfg, model


def _with_cf(cfg, cf):
    return dc.replace(cfg, moe=dc.replace(cfg.moe, capacity_factor=cf))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the model's modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("dispatch", ["sorted", "dense"])
def test_moe_block_matches_reference(ref, dispatch, cf):
    cfg_j, params, cfg, model = ref
    cfg_j, cfg = _with_cf(cfg_j, cf), _with_cf(cfg, cf)
    x = RNG.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda a: a[0], params["layers"])["moe"]
    y_j, aux_j = jax.jit(lambda p, x: JMOE.moe_block(p, cfg_j, x, dispatch=dispatch))(
        p_j, jnp.asarray(x))
    p = model.layers[0].moe
    y, aux = MOE.moe_block(p, cfg, torch.from_numpy(x), dispatch=dispatch)
    _close(y, y_j, 1e-5)
    _close(aux, aux_j, 1e-5)
    if dispatch == "sorted":  # capacity factor 1.0 drops rows, 8.0 none
        idx, _, _ = MOE._router(p, cfg, torch.from_numpy(x))
        per_expert = torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts)
        assert (int(per_expert.max()) > MOE.capacity(cfg, 32)) == (cf == 1.0)


def test_sorted_dispatch_equals_dense_without_drops(ref):
    _, _, cfg, model = ref
    cfg = _with_cf(cfg, 8.0)
    x = torch.from_numpy(RNG.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    ys, _ = MOE.moe_block(model.layers[1].moe, cfg, x, dispatch="sorted")
    yd, _ = MOE.moe_block(model.layers[1].moe, cfg, x, dispatch="dense")
    _close(ys, yd.numpy(), 1e-5)


def test_attention_with_cache_matches_reference(ref):
    cfg_j, params, cfg, model = ref
    b, s, max_len = 2, 8, 20
    x = RNG.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    k0 = RNG.normal(size=(b, max_len, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    k0[:, 5:] = 0.0  # five cached positions, as a prefill of five tokens leaves them
    cache_j = {"k": jnp.asarray(k0, jnp.bfloat16), "v": jnp.asarray(k0[::-1], jnp.bfloat16),
               "index": jnp.int32(5)}
    pos = np.broadcast_to(5 + np.arange(s, dtype=np.int32), (b, s))
    p_j = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    out_j, new_j = jax.jit(lambda p, x, c: JL.attention(p, cfg_j, x, jnp.asarray(pos),
                                                        cache=c))(p_j, jnp.asarray(x), cache_j)
    cache = {"k": torch.from_numpy(k0).to(torch.bfloat16),
             "v": torch.from_numpy(k0[::-1].copy()).to(torch.bfloat16),
             "index": torch.tensor(5, dtype=torch.int32)}
    out, new = L.attention(model.layers[0].attn, cfg, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()), cache=cache)
    _close(out, out_j, 1e-5)
    assert int(new["index"]) == int(new_j["index"]) == 5 + s
    for f in ("k", "v"):  # bfloat16 rows rounded from float32 values within 1e-6
        _close(new[f], np.asarray(new_j[f], np.float32), 1e-2)


def test_forward_matches_reference(ref):
    cfg_j, params, cfg, model = ref
    toks = RNG.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    logits_j, _, aux_j = jax.jit(lambda p, t: JM.forward(p, cfg_j, t))(params, jnp.asarray(toks))
    logits, caches, aux = M.forward(model, cfg, torch.from_numpy(toks))
    assert caches is None and logits.shape == (2, 16, cfg.vocab)
    _close(logits, logits_j, 1e-5)
    _close(aux, aux_j, 1e-5)


def test_prefill_and_serve_steps_match_reference_teacher_forced(ref):
    cfg_j, params, cfg, model = ref
    b, s, steps, max_len = 2, 16, 4, 20
    toks = RNG.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    forced = RNG.integers(0, cfg.vocab, (b, steps)).astype(np.int32)
    prefill_j = jax.jit(JST.make_prefill_step(cfg_j, max_len))
    serve_j = jax.jit(JST.make_serve_step(cfg_j))
    logits_j, caches_j = prefill_j(params, {"tokens": jnp.asarray(toks)})
    want = [np.asarray(logits_j[:, -1])]
    for i in range(steps):
        logits_j, caches_j = serve_j(params, {"token": jnp.asarray(forced[:, i:i + 1]),
                                              "caches": caches_j})
        want.append(np.asarray(logits_j[:, -1]))
    want = np.stack(want, 1)
    got = generate(model, cfg, toks, gen=steps + 1, max_len=max_len, force=forced,
                   keep_logits=True)
    np.testing.assert_allclose(got.logits, want, rtol=2e-3, atol=2e-3)
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-3
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.tokens[clear], want.argmax(-1)[clear])


def test_init_cache_layout_and_unported_configs(ref):
    """The cache of the MoE model; and the configs this module once saw
    refused, now served: deepseek-v3's dense-prefix MoE stack caches a
    (dense, MoE) pair of MLA latents, and the MoE config as an SSM family
    builds Mamba blocks and a Mamba cache."""
    _, _, cfg, _ = ref
    c = M.init_cache(cfg, 3, 24, device="cpu")
    assert c["k"].shape == (cfg.n_layers, 3, 24, cfg.n_kv_heads, cfg.d_head)
    assert c["k"].dtype == torch.bfloat16 and c["index"].device.type == "cpu"
    ds = get_config("deepseek-v3-671b", smoke=True)
    dense_c, moe_c = M.init_cache(ds, 3, 24, device="cpu")
    assert dense_c["latent"].shape == (ds.moe.first_k_dense, 3, 24, ds.mla.kv_lora_rank)
    assert moe_c["k_rope"].shape == (ds.n_layers - ds.moe.first_k_dense, 3, 24,
                                     ds.mla.qk_rope_head_dim)
    ssm = dc.replace(cfg, family="ssm", ssm=get_config("mamba2-2.7b", smoke=True).ssm)
    model = M.init(ssm, torch.Generator().manual_seed(0))
    assert all(blk.kind == "mamba" for blk in model.layers)
    assert M.init_cache(ssm, 3, 24, device="cpu")["ssm"].dtype == torch.float32


def test_dense_family_forward_matches_reference():
    cfg_j = dc.replace(j_get_config(ARCH, smoke=True), family="dense", moe=None, n_layers=1)
    params = _j_init(cfg_j, 1)
    cfg = dc.replace(get_config(ARCH, smoke=True), family="dense", moe=None, n_layers=1)
    model = M.params_from_numpy(cfg, params, device="cpu")
    toks = RNG.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    logits_j, _, _ = jax.jit(lambda p, t: JM.forward(p, cfg_j, t))(params, jnp.asarray(toks))
    _close(M.forward(model, cfg, torch.from_numpy(toks))[0], logits_j, 1e-5)


def test_random_init_uses_reference_scales_and_serves():
    cfg = get_config(ARCH, smoke=True)
    model = M.init(cfg, torch.Generator().manual_seed(3))
    moe = model.layers[0].moe
    assert abs(float(moe.wi.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(moe.wo.std()) * cfg.moe.d_ff_expert ** 0.5 - 1.0) < 0.05
    assert abs(float(model.embed.std()) / 0.01 - 1.0) < 0.05
    out = generate(model, cfg, torch.zeros((2, 8), dtype=torch.int64), gen=3, max_len=11)
    assert out.tokens.shape == (2, 3)


# ---------------------------------------------------------------------------
# the kernels' stored reference results
# ---------------------------------------------------------------------------


def compute(name: str) -> dict[str, np.ndarray]:
    """The reference's arrays of case ``name``."""
    kind = name.split("-")[0]
    return {"gmm": compute_gmm, "tiles": compute_tiles,
            "bitonic_ops": compute_bitonic_ops}[kind](name)


@functools.lru_cache(maxsize=1)
def _stored_arrays():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict[str, np.ndarray]:
    arrays = _stored_arrays()
    got = {k.split("|", 1)[1]: arrays[k] for k in arrays.files if k.startswith(f"{name}|")}
    if not got:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_moe_reference.py")
    return got


@pytest.mark.parametrize("name", LIVE_CASES)
def test_stored_reference_is_the_reference_output(name):
    """Cases recomputed live through the JAX package equal the stored file
    bit for bit (the script's ``--check`` recomputes all)."""
    got, want = compute(name), stored(name)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the grouped matmul's plain version
# ---------------------------------------------------------------------------


def gmm_inputs(name: str):
    """Case ``gmm-<dtype>-E-C-D-F-block_m``: x (E*C, D) and w (E, D, F)
    in float32, the dtype and the shape."""
    _, dtype, *dims = name.split("-")
    e, c, d, f, block_m = map(int, dims)
    rng = case_rng(name)
    x = rng.normal(size=(e * c, d)).astype(np.float32)
    w = (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    return x, w, dtype, (e, c, d, f, block_m)


def compute_gmm(name: str) -> dict:
    """The Pallas kernel in interpret mode (float32 values of its output)."""
    x, w, dtype, (_, c, _, _, block_m) = gmm_inputs(name)
    jdt = GMM_DTYPES[dtype][0]
    out = j_grouped_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt), capacity=c,
                           block_m=block_m)
    return {"out": np.asarray(out.astype(jnp.float32))}


@pytest.mark.parametrize("e,c,d,f,block_m", GMM_SHAPES)
@pytest.mark.parametrize("dtype", list(GMM_DTYPES))
def test_grouped_matmul_plain_matches_pallas(e, c, d, f, block_m, dtype):
    x, w, _, _ = gmm_inputs(f"gmm-{dtype}-{e}-{c}-{d}-{f}-{block_m}")
    want = stored(f"gmm-{dtype}-{e}-{c}-{d}-{f}-{block_m}")["out"]
    tdt = GMM_DTYPES[dtype][1]
    got = ops.moe_grouped_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                                 capacity=c)
    assert got.dtype == tdt and got.shape == (e * c, f)
    _close(got, want, 1e-4 if dtype == "float32" else 2e-2)  # test_kernels.py's tolerances


def test_grouped_matmul_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="E\\*C"):
        gm.grouped_matmul_plain(torch.zeros(10, 4), torch.zeros(2, 4, 3), capacity=4)


# ---------------------------------------------------------------------------
# the bitonic merge-absorb's plain version
# ---------------------------------------------------------------------------


def _assert_states(got: AggState, want: dict):
    g = state_to_numpy(got)
    np.testing.assert_array_equal(g["keys"], want["keys"])
    np.testing.assert_array_equal(g["count"], want["count"])
    for f in ("sum", "min", "max"):
        np.testing.assert_allclose(g[f], want[f], rtol=1e-4, atol=1e-5, err_msg=f)


def tile_inputs(n: int):
    """test_kernels.py's tiles: sorted keys with duplicates, unit counts,
    2-wide planes, ``n`` rows a side (keys, counts, planes of each)."""
    rng = np.random.default_rng(n)

    def mk():
        k = np.sort(rng.integers(0, n // 2, size=(1, n)).astype(np.uint32), -1)
        return k, np.ones((1, n), np.int32), rng.normal(size=(1, 2, n)).astype(np.float32)

    return mk(), mk()


def compute_tiles(name: str) -> dict:
    """The Pallas kernel's tiles in interpret mode and the reference's own
    compaction."""
    (ka, ca, va), (kb, cb, vb) = tile_inputs(int(name.split("-")[1]))
    args = [jnp.asarray(x) for x in (ka, ca, va, va, va, kb, cb, vb, vb, vb)]
    k2, c2, s2, mn2, mx2, tails = merge_absorb_tiles(*args)
    want = kops._compact(k2[0], c2, s2, mn2, mx2, tails, (2, 2, 2))
    return {f: np.asarray(getattr(want, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def tiles_reference():
    """``get(n)``: the two states of :func:`tile_inputs` and the
    reference's result on them (stored)."""

    def state(k, c, v):
        plane = v[0].T.copy()
        return state_from_numpy({"keys": k[0], "count": c[0], "sum": plane, "min": plane,
                                 "max": plane}, device="cpu")

    def get(n):
        a, b = tile_inputs(n)
        return state(*a), state(*b), stored(f"tiles-{n}")

    return get


@pytest.mark.parametrize("n", TILE_SIZES)
def test_bitonic_plain_matches_merge_absorb_tiles(n, tiles_reference):
    """The Pallas kernel's tiles and the reference's compaction against
    the port's plain version on the same states."""
    a, b, want = tiles_reference(n)
    _assert_states(ops.merge_absorb_sorted_bitonic(a, b), want)


def _absorbed(rng, n, domain, empty_tail, width):
    """A duplicate-free key-sorted state (NumPy arrays) of capacity ``n``
    whose last ``empty_tail`` rows are EMPTY (neutral payloads)."""
    live = n - empty_tail
    k = np.unique(rng.integers(0, domain, 4 * live).astype(np.uint32))[:live]
    live = k.size
    keys = np.full(n, np.iinfo(np.uint32).max, np.uint32)
    keys[:live] = k
    pay = rng.normal(size=(n, width)).astype(np.float32)
    alive = (np.arange(n) < live)[:, None]
    return {"keys": keys, "count": alive[:, 0].astype(np.int32),
            "sum": np.where(alive, pay, 0.0).astype(np.float32),
            "min": np.where(alive, pay, np.inf).astype(np.float32),
            "max": np.where(alive, pay, -np.inf).astype(np.float32)}


def bitonic_ops_inputs(name: str):
    """Case ``bitonic_ops-<na>-<nb>-<width>``: two absorbed states."""
    na, nb, width = map(int, name.split("-")[1:])
    rng = case_rng(name)
    return _absorbed(rng, na, 900, na // 5, width), _absorbed(rng, nb, 900, nb // 3, width)


def compute_bitonic_ops(name: str) -> dict:
    a, b = bitonic_ops_inputs(name)
    ja, jb = (jso.AggState(*(jnp.asarray(s[f]) for f in FIELDS)) for s in (a, b))
    want = jax.jit(kops.merge_absorb_sorted_bitonic)(ja, jb)
    return {f: np.asarray(getattr(want, f)) for f in FIELDS}


@pytest.mark.parametrize("na,nb,width", BITONIC_OPS)
def test_bitonic_ops_matches_reference_ops(na, nb, width):
    a, b = bitonic_ops_inputs(f"bitonic_ops-{na}-{nb}-{width}")
    want = stored(f"bitonic_ops-{na}-{nb}-{width}")
    got = ops.merge_absorb_sorted_bitonic(state_from_numpy(a, device="cpu"),
                                          state_from_numpy(b, device="cpu"))
    assert got.capacity == na + nb == want["keys"].shape[0]
    _assert_states(got, want)


def test_bitonic_rejects_u64_keys():
    a = state_from_numpy({"keys": np.arange(4, dtype=np.uint64),
                          "count": np.ones(4, np.int32), "sum": np.zeros((4, 0), np.float32),
                          "min": np.zeros((4, 0), np.float32),
                          "max": np.zeros((4, 0), np.float32)}, device="cpu")
    with pytest.raises(ValueError, match="u32"):
        ma.merge_absorb_bitonic_plain(a, a)


# ---------------------------------------------------------------------------
# the bitonic kernel's network: its plan, and its passes emulated in NumPy
# ---------------------------------------------------------------------------

_EMPTY32 = 0xFFFFFFFF
_PHASE3 = [(1_064_960, 16_384), (1_179_648, 65_536), (1_179_648, 1_179_648)]


def _log2(x: int) -> int:
    return x.bit_length() - 1


@pytest.mark.parametrize("tile", [16, ma.TILE])
@pytest.mark.parametrize("na,nb", [
    (0, 0), (1, 0), (0, 1), (3, 5), (8191, 0), (8192, 0), (8193, 0), (4096, 4097),
    (65_535, 0), (65_537, 0), (5, 70_000), (1 << 20, 5), (3 << 20, 1 << 20),
    (1 << 30, 1 << 30), *_PHASE3,
])
def test_bitonic_plan_covers_every_stride_once(na, nb, tile):
    """The global passes and then the tile take each stride from m/2 down to
    1 once, in order; m is the next power of two of |a| + |b| (at least 2)."""
    m, tile_m, passes = ma.plan(na, nb, tile)
    assert m >= max(2, na + nb) and (m == 2 or m // 2 < na + nb) and m & (m - 1) == 0
    assert tile_m == min(m, tile)
    assert all(1 <= r <= ma.MAX_R for r in passes)
    strides, top = [], _log2(m) - 1
    for r in passes:
        strides += range(top, top - r, -1)
        top -= r
    strides += range(_log2(tile_m) - 1, -1, -1)
    assert strides == list(range(_log2(m) - 1, -1, -1))


@pytest.mark.parametrize("na,nb,want", [(*s, w) for s, w in zip(
    _PHASE3, [(1 << 21, (4, 4)), (1 << 21, (4, 4)), (1 << 22, (5, 4))])])
def test_bitonic_plan_at_the_wide_merge_shapes(na, nb, want):
    """The merge-absorb's shapes of the SF-10 aggregate: two global passes
    each, the rest in the kernel's tile of 8,192 words."""
    m, tile, passes = ma.plan(na, nb)
    assert (m, passes) == want and tile == ma.TILE == 8192
    # csrc/merge_aggregate.cu: the first stage as the words load, then four
    # passes of three
    assert _tile_passes(ma.TILE) == (1, 3, 3, 3, 3)


def _tile_passes(tile: int) -> tuple[int, ...]:
    """The stages of a tile grouped as the kernel groups them: the odd ones
    first, then passes of three (a thread's 8 words)."""
    lt = _log2(tile)
    return ((lt % 3,) if lt % 3 else ()) + (3,) * (lt // 3)


def _grouped_stages(w: np.ndarray, r: int, lo: int) -> None:
    """``r`` compare-exchange stages, strides ``2^(lo+r-1)`` .. ``2^lo``, on
    each row of ``w`` in place, grouped as the kernel's threads hold them:
    thread t the positions whose bits [lo, lo + r) vary and whose other
    bits are t's (each position exactly once)."""
    t = np.arange(w.shape[1] >> r)
    low = (1 << lo) - 1
    idx = ((t & ~low) << r | (t & low))[:, None] + (np.arange(1 << r) << lo)[None, :]
    assert np.array_equal(np.sort(idx.ravel()), np.arange(w.shape[1]))
    g = w[:, idx]
    for h in range(r - 1, -1, -1):
        for k in range(1 << r):
            if not k >> h & 1:
                x, y = g[..., k].copy(), g[..., k | 1 << h].copy()
                g[..., k], g[..., k | 1 << h] = np.minimum(x, y), np.maximum(x, y)
    w[:, idx] = g


def _emulate(ka: np.ndarray, kb: np.ndarray, tile: int = ma.TILE) -> np.ndarray:
    """The kernel's network on packed words (key << 32 | src), pass by pass:
    the permutation of ``a ++ b`` that its first |a| + |b| words give."""
    na, nb = ka.size, kb.size
    m, _, passes = ma.plan(na, nb, tile)
    p = np.arange(m, dtype=np.uint64)
    q = np.uint64(m - 1) - p  # row q of b, virtually padded to m - na rows
    key = np.full(m, _EMPTY32, np.uint64)
    key[:na] = ka
    in_b = (p >= na) & (q < nb)
    key[in_b] = kb[q[in_b]]
    w = (key << np.uint64(32) | np.where(p < na, p, np.uint64(m) + q))[None]
    top = _log2(m) - 1
    for r in passes:
        _grouped_stages(w, r, top - r + 1)
        top -= r
    # a network under a tile runs in one tile, the largest word above m
    w = np.concatenate([w, np.full((1, max(m, tile) - m), ~np.uint64(0))], 1).reshape(-1, tile)
    top = _log2(tile) - 1
    for r in _tile_passes(tile):
        _grouped_stages(w, r, top - r + 1)
        top -= r
    src = (w.ravel()[:na + nb] & np.uint64(_EMPTY32)).astype(np.int64)
    return np.where(src < m, src, src - m + na)


def _sorted_side(rng, n: int, domain: int, empty_frac: float) -> np.ndarray:
    k = rng.integers(0, domain, n).astype(np.uint64)
    k[rng.random(n) < empty_frac] = _EMPTY32
    return np.sort(k)


@pytest.mark.parametrize("na,nb,domain,empty_frac,tile", [
    (0, 0, 1, 0.0, ma.TILE), (0, 9, 20, 0.0, 16), (9, 0, 20, 0.0, 16),  # empty sides
    (1000, 1000, 1, 0.0, 64), (3000, 200, 1, 0.0, ma.TILE),            # all keys equal
    (700, 300, 50, 0.3, 32), (2500, 3000, 4000, 0.2, 16),               # interior EMPTY
    (1000, 1000, 1, 1.0, 64),                                           # all EMPTY
    (1023, 1, 900, 0.1, 64), (1024, 1, 900, 0.1, 64), (1000, 23, 900, 0.1, 64),  # 2^10 +- 1
    (600, 500, 800, 0.1, 128),      # |a| + |b| above n = next_pow2(max): m = 2n
    (6000, 3000, 9000, 0.1, ma.TILE), (8191, 1, 5000, 0.1, ma.TILE),  # one global pass; a tile
])
def test_bitonic_network_emulation_gives_the_plain_permutation(na, nb, domain, empty_frac,
                                                                tile):
    """The kernel's network, emulated on packed words with its passes and
    threads' positions, orders a ++ b as the plain version's stable argsort
    does."""
    rng = np.random.default_rng(na * 7919 + nb)
    ka, kb = _sorted_side(rng, na, domain, empty_frac), _sorted_side(rng, nb, domain, empty_frac)
    want = argsort_torch(torch.from_numpy(np.concatenate([ka, kb]).astype(np.int64)))
    np.testing.assert_array_equal(_emulate(ka, kb, tile), want.numpy())


@pytest.mark.parametrize("tile", [16, ma.TILE])
@pytest.mark.parametrize("n", [64, 256, 1024])
def test_bitonic_network_emulation_matches_merge_absorb_tiles(n, tile, tiles_reference):
    """The emulated network's order, gathered and combined, against the
    Pallas kernel's merge and the reference's compaction."""
    a, b, want = tiles_reference(n)
    perm = _emulate(a.keys.numpy().astype(np.uint64), b.keys.numpy().astype(np.uint64), tile)
    merged = take(concat_states(a, b), torch.from_numpy(perm))
    _assert_states(segmented_combine_torch(merged), want)

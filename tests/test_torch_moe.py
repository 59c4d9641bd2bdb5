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

The reference's functions run under ``jax.jit`` (one compile each).
"""
import dataclasses as dc

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
from repro_torch.core.types import FIELDS, AggState, state_from_numpy, state_to_numpy
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import merge_aggregate as ma
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch.serve import generate
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

ARCH = "qwen3-moe-30b-a3b"
RNG = np.random.default_rng(13)


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
    _, _, cfg, _ = ref
    c = M.init_cache(cfg, 3, 24, device="cpu")
    assert c["k"].shape == (cfg.n_layers, 3, 24, cfg.n_kv_heads, cfg.d_head)
    assert c["k"].dtype == torch.bfloat16 and c["index"].device.type == "cpu"
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        get_config("deepseek-v3-671b")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        M.init(dc.replace(cfg, family="ssm"), torch.Generator().manual_seed(0))


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
# the grouped matmul's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,c,d,f,block_m", [(2, 128, 128, 128, 128), (4, 256, 256, 384, 128),
                                             (8, 128, 512, 256, 128), (4, 8, 128, 128, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_plain_matches_pallas(e, c, d, f, block_m, dtype):
    x = RNG.normal(size=(e * c, d)).astype(np.float32)
    w = (RNG.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    want = j_grouped_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt), capacity=c,
                            block_m=block_m)
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


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_bitonic_plain_matches_merge_absorb_tiles(n):
    """test_kernels.py's tiles (sorted keys with duplicates, unit counts,
    2-wide planes) through the Pallas kernel and the reference's own
    compaction, against the port's plain version on the same states."""
    def mk():
        k = np.sort(RNG.integers(0, n // 2, size=(1, n)).astype(np.uint32), -1)
        return k, np.ones((1, n), np.int32), RNG.normal(size=(1, 2, n)).astype(np.float32)

    (ka, ca, va), (kb, cb, vb) = mk(), mk()
    args = [jnp.asarray(x) for x in (ka, ca, va, va, va, kb, cb, vb, vb, vb)]
    k2, c2, s2, mn2, mx2, tails = merge_absorb_tiles(*args)
    want = kops._compact(k2[0], c2, s2, mn2, mx2, tails, (2, 2, 2))
    want = {f: np.asarray(getattr(want, f)) for f in FIELDS}

    def state(k, c, v):
        plane = v[0].T.copy()
        return state_from_numpy({"keys": k[0], "count": c[0], "sum": plane, "min": plane,
                                 "max": plane}, device="cpu")

    _assert_states(ops.merge_absorb_sorted_bitonic(state(ka, ca, va), state(kb, cb, vb)), want)


def _absorbed(n, domain, empty_tail, width):
    """A duplicate-free key-sorted state (NumPy arrays) of capacity ``n``
    whose last ``empty_tail`` rows are EMPTY (neutral payloads)."""
    live = n - empty_tail
    k = np.unique(RNG.integers(0, domain, 4 * live).astype(np.uint32))[:live]
    live = k.size
    keys = np.full(n, np.iinfo(np.uint32).max, np.uint32)
    keys[:live] = k
    pay = RNG.normal(size=(n, width)).astype(np.float32)
    alive = (np.arange(n) < live)[:, None]
    return {"keys": keys, "count": alive[:, 0].astype(np.int32),
            "sum": np.where(alive, pay, 0.0).astype(np.float32),
            "min": np.where(alive, pay, np.inf).astype(np.float32),
            "max": np.where(alive, pay, -np.inf).astype(np.float32)}


@pytest.mark.parametrize("na,nb,width", [(700, 500, 2), (33, 129, 4)])
def test_bitonic_ops_matches_reference_ops(na, nb, width):
    a = _absorbed(na, 900, na // 5, width)
    b = _absorbed(nb, 900, nb // 3, width)
    ja, jb = (jso.AggState(*(jnp.asarray(s[f]) for f in FIELDS)) for s in (a, b))
    want = jax.jit(kops.merge_absorb_sorted_bitonic)(ja, jb)
    want = {f: np.asarray(getattr(want, f)) for f in FIELDS}
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

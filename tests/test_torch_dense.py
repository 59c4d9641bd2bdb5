"""The port's dense model family held against the JAX package's, on the
CPU: ``llama3-8b``, ``qwen2-1.5b``, ``granite-20b`` and
``mistral-large-123b``.

* ``config()`` and ``smoke_config()`` equal the reference's field by field,
  with equal parameter counts, for all ten of the reference's
  architectures; the registry builds every one of them and refuses a name
  it does not know;
* each smoke model, seeded NumPy weights in the reference's parameter
  pytree carried across with ``params_from_numpy``: ``forward`` within
  rtol/atol 1e-5, and the prefill step with 4 teacher-forced serve steps
  within 2e-3 (K/V go through a bfloat16 cache in both), greedy tokens
  equal wherever the top-2 gap exceeds that (``tests/test_torch_moe.py``'s
  tolerances);
* the same with the full config's ``act``, ``kv_dup``, ``qkv_bias`` and
  ``tie_embeddings`` swapped into the smoke config where they differ from
  it: ``granite-20b``'s gelu MLP and ``llama3-8b``'s duplicated decode
  cache, which the reference's smoke configs do not reach.

The reference's jitted forward and serve steps compile for seconds a case,
so its logits for ``CASES`` are computed by
``scripts/make_torch_dense_reference.py`` and read from
``tests/data/torch_dense_reference.npz``; one case is recomputed live.
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
from repro.launch import steps as JST
from repro.models import model as JM
from repro_torch.configs import ARCHS, all_arch_ids, get_config
from repro_torch.launch import serve as SV
from repro_torch.models import model as M
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_dense_reference.npz"
DENSE = ("llama3-8b", "qwen2-1.5b", "granite-20b", "mistral-large-123b")
# the reference's other architectures, and the ROADMAP Queue 1 item that ported each
OTHERS = [("deepseek-v3-671b", "3b"), ("mamba2-2.7b", "3c"), ("zamba2-2.7b", "3c"),
          ("qwen2-vl-2b", "3c"), ("hubert-xlarge", "3c")]
FULL_FLAGS = ("act", "kv_dup", "qkv_bias", "tie_embeddings")
B, S, STEPS, MAX_LEN = 2, 16, 4, 20


def model_config(arch: str, variant: str, get=j_get_config):
    """The smoke config, or (``"full_flags"``) the smoke config with the
    full config's activation, cache duplication, bias and tying."""
    cfg = get(arch, smoke=True)
    if variant == "full_flags":
        full = get(arch)
        cfg = dc.replace(cfg, **{f: getattr(full, f) for f in FULL_FLAGS})
    return cfg


CASES = {f"{arch}-smoke": (arch, "smoke") for arch in DENSE}
CASES.update({f"{arch}-full_flags": (arch, "full_flags") for arch in DENSE
              if model_config(arch, "full_flags") != model_config(arch, "smoke")})
STORED_CASES = tuple(CASES)


def case_rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def reference_weights(cfg_j, rng):
    """Weights in the reference's parameter pytree (its ``init`` traced for
    shapes only), drawn with NumPy: norm scales near 1, biases small, every
    other leaf N(0, 1/fan_in) with fan_in its second-to-last axis."""
    shapes = jax.eval_shape(lambda k: JM.init(cfg_j, k)[0], jax.random.PRNGKey(0))

    def draw(path, s):
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        if path[-1].key == "bias":
            return (0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
        return (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def inputs(name: str):
    """Case ``name``'s reference config, weights, prompt and forced tokens."""
    arch, variant = CASES[name]
    cfg_j = model_config(arch, variant)
    rng = case_rng(name)
    params = reference_weights(cfg_j, rng)
    toks = rng.integers(0, cfg_j.vocab, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg_j.vocab, (B, STEPS)).astype(np.int32)
    return cfg_j, params, toks, forced


def compute(name: str) -> dict[str, np.ndarray]:
    """The reference's logits of case ``name``: ``forward`` over the prompt,
    and the prefill step's last logits followed by 4 teacher-forced serve
    steps'."""
    cfg_j, params, toks, forced = inputs(name)
    fwd, _, _ = jax.jit(lambda p, t: JM.forward(p, cfg_j, t))(params, jnp.asarray(toks))
    prefill = jax.jit(JST.make_prefill_step(cfg_j, MAX_LEN))
    serve = jax.jit(JST.make_serve_step(cfg_j))
    logits, caches = prefill(params, {"tokens": jnp.asarray(toks)})
    steps = [np.asarray(logits[:, -1])]
    for i in range(STEPS):
        logits, caches = serve(params, {"token": jnp.asarray(forced[:, i:i + 1]),
                                        "caches": caches})
        steps.append(np.asarray(logits[:, -1]))
    return {"forward": np.asarray(fwd, np.float32),
            "serve": np.stack(steps, 1).astype(np.float32)}


@functools.lru_cache(maxsize=1)
def _stored_arrays():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict[str, np.ndarray]:
    arrays = _stored_arrays()
    got = {k.split("|", 1)[1]: arrays[k] for k in arrays.files if k.startswith(f"{name}|")}
    if not got:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_dense_reference.py")
    return got


# ---------------------------------------------------------------------------
# the configs and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE + tuple(a for a, _ in OTHERS) + ("qwen3-moe-30b-a3b",))
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(arch, smoke):
    cfg, want = get_config(arch, smoke=smoke), j_get_config(arch, smoke=smoke)
    assert dc.asdict(cfg) == dc.asdict(want)
    assert cfg.param_count() == want.param_count()
    assert cfg.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("arch,item", OTHERS)
def test_registry_refuses_the_other_architectures(arch, item):
    """The architectures the registry refused until ROADMAP Queue 1 item
    ``item`` ported them are now served: registered beside the dense
    family, their smoke models built; the registry still refuses a name it
    does not know."""
    assert set(DENSE) | {arch} <= set(all_arch_ids()) and len(ARCHS) == 10
    cfg = get_config(arch, smoke=True)
    model = M.init(cfg, torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in model.parameters()) > 0, item
    with pytest.raises(KeyError):
        get_config("gpt-0")


# ---------------------------------------------------------------------------
# the models against the reference's logits
# ---------------------------------------------------------------------------


def _port_model(name: str):
    arch, variant = CASES[name]
    cfg_j, params, toks, forced = inputs(name)
    cfg = model_config(arch, variant, get=get_config)
    assert dc.asdict(cfg) == dc.asdict(cfg_j)
    return cfg, M.params_from_numpy(cfg, params, device="cpu"), toks, forced


@pytest.mark.parametrize("name", STORED_CASES)
def test_forward_matches_reference(name):
    cfg, model, toks, _ = _port_model(name)
    logits, caches, aux = M.forward(model, cfg, torch.from_numpy(toks))
    assert caches is None and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), stored(name)["forward"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", STORED_CASES)
def test_prefill_and_serve_steps_match_reference_teacher_forced(name):
    cfg, model, toks, forced = _port_model(name)
    want = stored(name)["serve"]
    got = SV.generate(model, cfg, toks, gen=STEPS + 1, max_len=MAX_LEN, force=forced,
                      keep_logits=True)
    np.testing.assert_allclose(got.logits, want, rtol=2e-3, atol=2e-3)
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2e-3
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.tokens[clear], want.argmax(-1)[clear])
    if cfg.kv_dup > 1:  # the cache holds each kv head kv_dup times
        caches = M.init_cache(cfg, B, MAX_LEN, device="cpu")
        assert caches["k"].shape[3] == cfg.n_kv_heads * cfg.kv_dup


def test_stored_reference_is_the_reference_output():
    """One case recomputed live through the JAX package equals the stored
    file bit for bit (the script's ``--check`` recomputes all)."""
    name = "granite-20b-full_flags"
    got, want = compute(name), stored(name)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the serve driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_serve_drives_the_dense_family(arch):
    """``launch.serve.serve`` at its defaults (prompt 32, 16 tokens: a
    48-position cache, rounded up to whole attention chunks)."""
    ids, t_prefill, t_decode = SV.serve(arch, smoke=True, device="cpu")
    cfg = get_config(arch, smoke=True)
    assert ids.shape == (4, 16) and ids.min() >= 0 and ids.max() < cfg.vocab
    assert t_prefill > 0 and t_decode > 0


@pytest.mark.parametrize("positions,want", [(20, 20), (32, 32), (33, 64), (48, 64), (64, 64)])
def test_cache_len_takes_whole_attention_chunks(positions, want):
    assert SV.cache_len(get_config("llama3-8b", smoke=True), positions) == want

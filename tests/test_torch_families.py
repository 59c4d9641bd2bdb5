"""The port's remaining model families held against the JAX package's, on
the CPU, at the reference's smoke sizes (float32): ``deepseek-v3-671b``
(MLA, a dense prefix before the MoE layers, MTP weights),
``mamba2-2.7b`` (SSD), the hybrid ``zamba2-2.7b``, ``qwen2-vl-2b``
(M-RoPE, a front-end stub) and the encoder ``hubert-xlarge``.

Weights are drawn with NumPy in the reference's parameter pytree and
carried across with ``params_from_numpy``; inputs come from a per-case
seed.  Tolerances: rtol/atol 1e-5 for a forward and a module, as
``tests/test_torch_dense.py``'s; for the prefill step and 4 teacher-forced
serve steps rtol/atol 2^-8, one bfloat16 ulp, since MLA's latent, K/V and
Mamba's convolution window go through a bfloat16 cache in both, and a
float32 value the two compute 1e-6 apart can round to neighbouring
bfloat16 values (one of Mamba2's cached inputs does, and moves the logits
by 4.3e-3 where the dense family's K/V moved them by less than 2e-3);
greedy tokens equal wherever the top-2 gap exceeds that.

* the modules: ``mla_attention`` with and without a cache (the new
  latent and rotated key rows too); ``_ssd_chunked`` at chunks 8, 16 and
  64 from a carried state and from zero; ``mamba2_block`` without a
  cache, as a prefill from a cached state, and as a one-token decode;
  ``apply_mrope`` at the attention's sections and the default ones;
* each family's ``forward`` (logits, and deepseek's auxiliary loss) and its
  prefill and serve steps, teacher-forced; qwen2-vl forward from (B, S, D)
  embeddings with M-RoPE positions and from token ids without them (no
  rotation, as the reference); hubert's non-causal forward from frame
  embeddings;
* port-only checks: the chunked scan equals the step recurrence, a
  front-end stub's embeddings equal the looked-up tokens, an ``mrope``
  model without positions equals the same model with no rotary embedding,
  ``init_cache``'s layout equals the reference's for every architecture,
  ``A_log``, ``D`` and ``dt_bias`` stay float32 in a bfloat16 model, and the
  ``serve`` launcher and ``shape_skips`` for each family.

The reference's jitted programs compile for seconds a case, so its
results for ``STORED_CASES`` are computed by
``scripts/make_torch_families_reference.py`` and read from
``tests/data/torch_families_reference.npz``; one case is recomputed live.
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro_torch.configs import get_config
from repro_torch.launch import serve as SV
from repro_torch.launch import steps as ST
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_families_reference.npz"
FAMILIES = ("deepseek-v3-671b", "mamba2-2.7b", "zamba2-2.7b", "qwen2-vl-2b", "hubert-xlarge")
ALL_ARCHS = ("hubert-xlarge", "mamba2-2.7b", "deepseek-v3-671b", "qwen3-moe-30b-a3b",
             "llama3-8b", "qwen2-1.5b", "mistral-large-123b", "granite-20b", "zamba2-2.7b",
             "qwen2-vl-2b")
B, S, STEPS, MAX_LEN = 2, 16, 4, 20
SERVE_TOL = 2.0 ** -8  # one bfloat16 ulp: the caches' rounding
SSD_CASES = {f"ssd-{c}-{'state' if st else 'zero'}": (c, st)
             for c, st in ((8, True), (16, True), (64, True), (16, False))}
MAMBA_MODES = ("nocache", "prefill", "decode")
CASES = ([f"{arch}-model" for arch in FAMILIES] + ["mla-nocache", "mla-cache"]
         + list(SSD_CASES) + [f"mamba-{m}" for m in MAMBA_MODES] + ["mrope"])
STORED_CASES = tuple(CASES)
LIVE_CASE = "mamba-decode"


def case_rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def family_weights(cfg_j, rng):
    """Weights in the reference's parameter pytree (its ``init`` traced for
    shapes only), drawn with NumPy: norm scales and Mamba's ``D`` near 1,
    biases small, ``A_log`` the log of U[1, 16], every other leaf N(0,
    1/fan_in) with fan_in its second-to-last axis."""
    shapes = jax.eval_shape(lambda k: JM.init(cfg_j, k)[0], jax.random.PRNGKey(0))

    def draw(path, s):
        key = path[-1].key
        if key in ("scale", "D"):
            a = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif key in ("bias", "conv_b", "dt_bias"):
            a = 0.1 * rng.standard_normal(s.shape)
        elif key == "A_log":
            a = np.log(rng.uniform(1.0, 16.0, s.shape))
        else:
            a = rng.standard_normal(s.shape) / np.sqrt(s.shape[-2])
        return a.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def family(arch: str):
    """The reference's smoke config of ``arch`` and its weights (drawn from
    the seed of case ``<arch>-model``)."""
    cfg_j = j_get_config(arch, smoke=True)
    return cfg_j, family_weights(cfg_j, case_rng(f"{arch}-model"))


def port_model(arch: str):
    cfg_j, params = family(arch)
    cfg = get_config(arch, smoke=True)
    assert dc.asdict(cfg) == dc.asdict(cfg_j)
    return cfg, M.params_from_numpy(cfg, params, device="cpu")


def _row(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# the cases' inputs and the reference's results
# ---------------------------------------------------------------------------


def model_inputs(arch: str) -> dict:
    """Case ``<arch>-model``'s prompt (ids, or embeddings for a front-end
    stub), forced tokens and, for M-RoPE, (t, h, w) positions that differ
    by axis."""
    cfg_j, _ = family(arch)
    rng = case_rng(f"{arch}-model-inputs")
    out = {"toks": rng.integers(0, cfg_j.vocab, (B, S)).astype(np.int32),
           "forced": rng.integers(0, cfg_j.vocab, (B, STEPS)).astype(np.int32)}
    if cfg_j.frontend_stub:
        out["embeds"] = rng.normal(size=(B, S, cfg_j.d_model)).astype(np.float32)
    if cfg_j.rope == "mrope":
        out["mrope_pos"] = np.sort(rng.integers(0, 64, (3, B, S)), -1).astype(np.int32)
    return out


def _prompt(inp: dict) -> np.ndarray:
    return inp.get("embeds", inp["toks"])


def compute_model(arch: str) -> dict:
    """The reference's ``forward`` over the prompt (with M-RoPE positions
    where the model has them, and again from token ids without), and its
    prefill step's last logits followed by 4 teacher-forced serve steps',
    built as the reference's ``serve`` builds them."""
    cfg_j, params = family(arch)
    inp = model_inputs(arch)
    prompt = jnp.asarray(_prompt(inp))
    mpos = None if "mrope_pos" not in inp else jnp.asarray(inp["mrope_pos"])
    fwd = jax.jit(lambda p, t, mp: JM.forward(p, cfg_j, t, mrope_pos=mp))
    logits, _, aux = fwd(params, prompt, mpos)
    out = {"forward": np.asarray(logits, np.float32), "aux": np.asarray(aux, np.float32)}
    if mpos is not None:
        out["forward_no_mrope"] = np.asarray(
            fwd(params, jnp.asarray(inp["toks"]), None)[0], np.float32)
    prefill = jax.jit(JST.make_prefill_step(cfg_j, MAX_LEN))
    serve = jax.jit(JST.make_serve_step(cfg_j))
    batch = {"tokens": prompt}
    if mpos is not None:
        batch["mrope_pos"] = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (3, B, S))
    logits, caches = prefill(params, batch)
    steps = [np.asarray(logits[:, -1])]
    for i in range(STEPS):
        step = {"token": jnp.asarray(inp["forced"][:, i:i + 1]), "caches": caches}
        if mpos is not None:
            step["mrope_pos"] = jnp.full((3, B, 1), S + i, jnp.int32)
        logits, caches = serve(params, step)
        steps.append(np.asarray(logits[:, -1]))
    out["serve"] = np.stack(steps, 1).astype(np.float32)
    return out


def mla_inputs(name: str) -> dict:
    """x (2, 8, D) at positions 5..12; with a cache, 5 positions filled of
    20 (bfloat16, as ``init_cache`` makes them)."""
    cfg_j, _ = family("deepseek-v3-671b")
    m, rng = cfg_j.mla, case_rng(name)
    out = {"x": rng.normal(size=(2, 8, cfg_j.d_model)).astype(np.float32),
           "pos": np.broadcast_to(5 + np.arange(8, dtype=np.int32), (2, 8)).copy()}
    if name == "mla-cache":
        for f, w in (("latent", m.kv_lora_rank), ("k_rope", m.qk_rope_head_dim)):
            c = rng.normal(size=(2, 20, w)).astype(np.float32)
            c[:, 5:] = 0.0
            out[f] = np.array(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32))
    return out


def compute_mla(name: str) -> dict:
    cfg_j, params = family("deepseek-v3-671b")
    inp = mla_inputs(name)
    cache = None
    if name == "mla-cache":
        cache = {f: jnp.asarray(inp[f], jnp.bfloat16) for f in ("latent", "k_rope")}
        cache["index"] = jnp.int32(5)
    out, new = jax.jit(lambda p, x, c: JL.mla_attention(p, cfg_j, x, jnp.asarray(inp["pos"]),
                                                        cache=c))(
        _row(params["dense_layers"])["attn"], jnp.asarray(inp["x"]), cache)
    res = {"out": np.asarray(out, np.float32)}
    if new is not None:
        res.update({f: np.asarray(new[f], np.float32) for f in ("latent", "k_rope")})
        res["index"] = np.asarray(new["index"])
    return res


def ssd_inputs(name: str) -> dict:
    """x (2, 64, 4, 8); dt softplus'd; A negative; B, C (2, 64, 2, 6): two
    heads to a group; a carried state (2, 4, 8, 6) or none.  B and C of the
    scale the block's SiLU gives them (|.| about 0.5)."""
    _, with_state = SSD_CASES[name]
    rng = case_rng(name)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    out = {"x": f(2, 64, 4, 8), "dt": np.log1p(np.exp(f(2, 64, 4) - 1.0)).astype(np.float32),
           "A": -np.exp(np.linspace(0.0, np.log(16.0), 4)).astype(np.float32),
           "B": 0.5 * f(2, 64, 2, 6), "C": 0.5 * f(2, 64, 2, 6)}
    if with_state:
        out["state"] = f(2, 4, 8, 6)
    return out


def compute_ssd(name: str) -> dict:
    chunk, _ = SSD_CASES[name]
    inp = ssd_inputs(name)
    state = inp.get("state")
    y, final = jax.jit(JSSM._ssd_chunked, static_argnums=5)(
        *(jnp.asarray(inp[k]) for k in ("x", "dt", "A", "B", "C")), chunk,
        None if state is None else jnp.asarray(state))
    return {"y": np.asarray(y), "final": np.asarray(final)}


def mamba_inputs(name: str) -> dict:
    """x (2, 16, D) (one token to decode); the cache's convolution window in
    bfloat16 (``init_cache``'s dtype) and a float32 state."""
    cfg_j, _ = family("mamba2-2.7b")
    s, rng = cfg_j.ssm, case_rng(name)
    conv_dim = cfg_j.d_inner_ssm + 2 * s.n_groups * s.d_state
    out = {"x": rng.normal(size=(2, 1 if name == "mamba-decode" else 16,
                                 cfg_j.d_model)).astype(np.float32)}
    if name != "mamba-nocache":
        conv = rng.normal(size=(2, s.d_conv - 1, conv_dim)).astype(np.float32)
        out["conv"] = np.array(jnp.asarray(conv, jnp.bfloat16).astype(jnp.float32))
        out["ssm"] = (0.3 * rng.normal(size=(2, cfg_j.n_ssm_heads, s.head_dim, s.d_state))
                      ).astype(np.float32)
    return out


def compute_mamba(name: str) -> dict:
    cfg_j, params = family("mamba2-2.7b")
    inp = mamba_inputs(name)
    cache = None
    if "conv" in inp:
        cache = {"conv": jnp.asarray(inp["conv"], jnp.bfloat16), "ssm": jnp.asarray(inp["ssm"])}
    out, new = jax.jit(lambda p, x, c: JSSM.mamba2_block(p, cfg_j, x, cache=c))(
        _row(params["layers"])["mixer"], jnp.asarray(inp["x"]), cache)
    res = {"out": np.asarray(out)}
    if new is not None:
        res.update({"conv": np.asarray(new["conv"], np.float32), "ssm": np.asarray(new["ssm"])})
    return res


MROPE_SHAPES = {"attention": 16, "default": 128}  # d_head: sections of the attention, default


def mrope_inputs() -> dict:
    rng = case_rng("mrope")
    return {f"x-{k}": rng.normal(size=(2, 8, 3, d)).astype(np.float32)
            for k, d in MROPE_SHAPES.items()} | {
        "pos3": rng.integers(0, 1000, (3, 2, 8)).astype(np.int32)}


def compute_mrope(name: str) -> dict:
    inp = mrope_inputs()
    pos3 = jnp.asarray(inp["pos3"])
    half = MROPE_SHAPES["attention"] // 2
    sec = (half - 2 * (half * 3 // 8), half * 3 // 8, half * 3 // 8)  # the attention's split
    return {"attention": np.asarray(JL.apply_mrope(jnp.asarray(inp["x-attention"]), pos3,
                                                   1e4, sections=sec)),
            "default": np.asarray(JL.apply_mrope(jnp.asarray(inp["x-default"]), pos3, 1e6))}


def compute(name: str) -> dict[str, np.ndarray]:
    """The reference's arrays of case ``name``."""
    if name.endswith("-model"):
        return compute_model(name[:-len("-model")])
    if name.startswith("mla-"):
        return compute_mla(name)
    if name in SSD_CASES:
        return compute_ssd(name)
    if name.startswith("mamba-"):
        return compute_mamba(name)
    return compute_mrope(name)


@functools.lru_cache(maxsize=1)
def _stored_arrays():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict[str, np.ndarray]:
    arrays = _stored_arrays()
    got = {k.split("|", 1)[1]: arrays[k] for k in arrays.files if k.startswith(f"{name}|")}
    if not got:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_families_reference.py")
    return got


def _close(got, want, tol: float):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_stored_reference_is_the_reference_output():
    """One case recomputed live through the JAX package equals the stored
    file bit for bit (the script's ``--check`` recomputes all)."""
    got, want = compute(LIVE_CASE), stored(LIVE_CASE)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mla-nocache", "mla-cache"])
def test_mla_attention_matches_reference(name):
    cfg, model = port_model("deepseek-v3-671b")
    inp, want = mla_inputs(name), stored(name)
    cache = None
    if name == "mla-cache":
        cache = {f: torch.from_numpy(inp[f]).to(torch.bfloat16) for f in ("latent", "k_rope")}
        cache["index"] = torch.tensor(5, dtype=torch.int32)
    out, new = L.mla_attention(model.dense_layers[0].attn, cfg, torch.from_numpy(inp["x"]),
                               torch.from_numpy(inp["pos"]), cache=cache)
    _close(out, want["out"], 1e-5)
    if cache is None:
        assert new is None
        return
    assert int(new["index"]) == int(want["index"]) == 13
    assert new["latent"] is cache["latent"]  # the rows are written in place
    for f in ("latent", "k_rope"):  # bfloat16 rows rounded from float32 values within 1e-6
        _close(new[f], want[f], 1e-2)
        np.testing.assert_array_equal(new[f][:, :5].float().numpy(), inp[f][:, :5])


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_chunked_matches_reference(name):
    chunk, _ = SSD_CASES[name]
    inp, want = ssd_inputs(name), stored(name)
    state = inp.get("state")
    y, final = SSM._ssd_chunked(
        *(torch.from_numpy(inp[k]) for k in ("x", "dt", "A", "B", "C")), chunk,
        ssm_state=None if state is None else torch.from_numpy(state))
    assert final.dtype == torch.float32
    _close(y, want["y"], 1e-5)
    _close(final, want["final"], 1e-5)


def test_ssd_chunked_refuses_a_partial_chunk():
    inp = ssd_inputs("ssd-16-zero")
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        SSM._ssd_chunked(*(torch.from_numpy(inp[k]) for k in ("x", "dt", "A", "B", "C")), 24)


@pytest.mark.parametrize("mode", MAMBA_MODES)
def test_mamba2_block_matches_reference(mode):
    name = f"mamba-{mode}"
    cfg, model = port_model("mamba2-2.7b")
    inp, want = mamba_inputs(name), stored(name)
    cache = None
    if "conv" in inp:
        cache = {"conv": torch.from_numpy(inp["conv"]).to(torch.bfloat16),
                 "ssm": torch.from_numpy(inp["ssm"])}
    out, new = SSM.mamba2_block(model.layers[0].mixer, cfg, torch.from_numpy(inp["x"]),
                                cache=cache)
    _close(out, want["out"], 1e-5)
    if cache is None:
        assert new is None
        return
    # prefill: the window in the cache's dtype; decode: promoted with the input, as the reference
    assert new["conv"].dtype == (torch.bfloat16 if mode == "prefill" else torch.float32)
    assert new["ssm"].dtype == torch.float32
    _close(new["conv"], want["conv"], 1e-5 if mode == "decode" else 1e-2)
    _close(new["ssm"], want["ssm"], 1e-5)


def test_chunked_scan_equals_the_step_recurrence():
    """A prefill of 16 tokens from a zero cache and 16 one-token decode
    steps give the same outputs and the same final state (float32 cache:
    no rounding between the two)."""
    cfg, model = port_model("mamba2-2.7b")
    mixer = model.layers[0].mixer
    x = torch.from_numpy(case_rng("scan-vs-steps").normal(size=(2, 16, cfg.d_model))
                         .astype(np.float32))
    zero = {k: v[0] for k, v in M.init_cache(cfg, 2, 1, dtype=torch.float32,
                                             device="cpu").items()}
    y_scan, c_scan = SSM.mamba2_block(mixer, cfg, x, cache=zero)
    cache, ys = zero, []
    for t in range(16):
        y, cache = SSM.mamba2_block(mixer, cfg, x[:, t:t + 1], cache=cache)
        ys.append(y)
    _close(torch.cat(ys, 1), y_scan.numpy(), 1e-4)
    _close(cache["ssm"], c_scan["ssm"].numpy(), 1e-4)
    _close(cache["conv"], c_scan["conv"].numpy(), 1e-5)


def test_apply_mrope_matches_reference():
    inp, want = mrope_inputs(), stored("mrope")
    pos3 = torch.from_numpy(inp["pos3"])
    got = L.apply_mrope(torch.from_numpy(inp["x-attention"]), pos3, 1e4,
                        sections=L.mrope_sections(MROPE_SHAPES["attention"]))
    _close(got, want["attention"], 1e-5)
    _close(L.apply_mrope(torch.from_numpy(inp["x-default"]), pos3, 1e6), want["default"], 1e-5)
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(torch.from_numpy(inp["x-attention"]), pos3, 1e4)


def test_mrope_model_without_positions_is_not_rotated():
    """As the reference (``layers.py``'s ``attention``): an ``mrope`` model
    given no ``mrope_pos`` applies no rotary embedding at all."""
    cfg, model = port_model("qwen2-vl-2b")
    toks = torch.from_numpy(model_inputs("qwen2-vl-2b")["toks"])
    got = M.forward(model, cfg, toks)[0]
    plain = M.forward(model, dc.replace(cfg, rope="none"), toks)[0]
    assert torch.equal(got, plain)
    _close(got, stored("qwen2-vl-2b-model")["forward_no_mrope"], 1e-5)


def test_frontend_embeddings_are_used_as_they_come():
    """A front-end stub's (B, S, D) input is the hidden state; the same
    rows looked up from token ids give the same logits."""
    for arch in ("qwen2-vl-2b", "hubert-xlarge"):
        cfg, model = port_model(arch)
        toks = torch.from_numpy(model_inputs(arch)["toks"])
        by_ids = M.forward(model, cfg, toks)[0]
        by_rows = M.forward(model, cfg, model.embed[toks.long()].detach().numpy())[0]
        assert torch.equal(by_ids, by_rows)


# ---------------------------------------------------------------------------
# the families against the reference's logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch):
    cfg, model = port_model(arch)
    inp, want = model_inputs(arch), stored(f"{arch}-model")
    logits, caches, aux = M.forward(model, cfg, _prompt(inp), mrope_pos=inp.get("mrope_pos"))
    assert logits.shape == (B, S, cfg.vocab)
    assert caches in (None, (None, None))
    _close(logits, want["forward"], 1e-5)
    _close(aux, want["aux"], 1e-5)
    if cfg.moe is not None:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_serve_steps_match_reference_teacher_forced(arch):
    cfg, model = port_model(arch)
    inp, want = model_inputs(arch), stored(f"{arch}-model")["serve"]
    got = SV.generate(model, cfg, _prompt(inp), gen=STEPS + 1, max_len=MAX_LEN,
                      force=inp["forced"], keep_logits=True)
    np.testing.assert_allclose(got.logits, want, rtol=SERVE_TOL, atol=SERVE_TOL)
    top2 = np.sort(want, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > SERVE_TOL
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.tokens[clear], want.argmax(-1)[clear])


def test_deepseek_carries_the_dense_prefix_and_mtp_weights():
    """The reference's tree maps onto the port's one to one: the dense
    prefix and the MoE layers stacked, MTP's block and projection as they
    are (``params_from_numpy`` raises on any leaf without a place)."""
    cfg, model = port_model("deepseek-v3-671b")
    _, params = family("deepseek-v3-671b")
    assert len(model.dense_layers) == cfg.moe.first_k_dense == 1
    assert len(model.layers) == cfg.n_layers - 1
    assert isinstance(model.mtp_block.attn, L.MLA)
    np.testing.assert_array_equal(model.mtp_proj.kernel.numpy(),
                                  np.asarray(params["mtp_proj"]["kernel"]))
    np.testing.assert_array_equal(model.dense_layers[0].attn.wkv_b.kernel.numpy(),
                                  np.asarray(params["dense_layers"]["attn"]["wkv_b"]["kernel"][0]))


def test_hybrid_carries_the_shared_block_and_its_lora():
    cfg, model = port_model("zamba2-2.7b")
    _, params = family("zamba2-2.7b")
    n_groups = cfg.n_layers // cfg.hybrid_shared_period
    assert model.lora_a.shape == (n_groups, 2 * cfg.d_model, cfg.hybrid_lora_rank)
    np.testing.assert_array_equal(model.lora_b.numpy(), np.asarray(params["lora_b"]))
    np.testing.assert_array_equal(model.shared.attn.wq.kernel.numpy(),
                                  np.asarray(params["shared"]["attn"]["wq"]["kernel"]))


# ---------------------------------------------------------------------------
# caches, dtypes, the registry and the serve launcher
# ---------------------------------------------------------------------------


def _leaves(tree) -> dict:
    """{path: leaf} of a cache tree (dicts and tuples)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {(): tree}
    return {(k,) + path: leaf for k, sub in items for path, leaf in _leaves(sub).items()}


def _layout(tree) -> dict:
    return {path: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in _leaves(tree).items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_init_cache_layout_equals_reference(arch):
    """Every field, shape and dtype of the reference's ``init_cache``
    (traced for shapes only), the pairs of the dense-prefix and hybrid
    families in the reference's order; the indices on the host."""
    cfg_j = j_get_config(arch, smoke=True)
    want = _layout(jax.eval_shape(lambda: JM.init_cache(cfg_j, 3, 24)))
    got = M.init_cache(get_config(arch, smoke=True), 3, 24, device="cpu")
    assert _layout(got) == want
    assert all(path[-1] != "index" or t.device.type == "cpu"
               for path, t in _leaves(got).items())


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_parameters_stay_float32_in_a_bfloat16_model(arch):
    """``A_log``, ``D`` and ``dt_bias`` are float32 in the reference's bf16
    tree; the port's random init and ``params_from_numpy`` keep them so,
    every other parameter bfloat16."""
    cfg_j = dc.replace(j_get_config(arch, smoke=True), dtype="bfloat16")
    params = family_weights(cfg_j, case_rng(f"{arch}-bf16"))
    cfg = dc.replace(get_config(arch, smoke=True), dtype="bfloat16")
    f32 = ("A_log", "D", "dt_bias")
    for model in (M.params_from_numpy(cfg, params, device="cpu"),
                  M.init(cfg, torch.Generator().manual_seed(0))):
        dtypes = {n: t.dtype for n, t in model.named_parameters()}
        assert all((d == torch.float32) == (n.rsplit(".", 1)[-1] in f32)
                   for n, d in dtypes.items()), dtypes
    ref = params["layers"]["mixer"]
    assert all(ref[k].dtype == np.float32 for k in f32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_drives_each_family(arch):
    """``launch.serve.serve`` at its defaults (prompt 32, 16 tokens)."""
    ids, t_prefill, t_decode = SV.serve(arch, smoke=True, device="cpu")
    cfg = get_config(arch, smoke=True)
    assert ids.shape == (4, 16) and ids.min() >= 0 and ids.max() < cfg.vocab
    assert t_prefill > 0 and t_decode > 0


@pytest.mark.parametrize("shape", list(ST.SHAPES))
def test_shape_skips_equals_reference(shape):
    assert ST.SHAPES == JST.SHAPES
    for arch in ALL_ARCHS:
        assert ST.shape_skips(get_config(arch), shape) == JST.shape_skips(
            j_get_config(arch), shape)
    assert ST.shape_skips(get_config("hubert-xlarge"), "decode_32k") is not None

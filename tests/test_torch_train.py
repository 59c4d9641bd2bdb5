"""The port's training path held against the JAX package's, on the CPU, at
the reference's smoke sizes (float32), with inputs from per-case NumPy
seeds and state carried across by ``params_from_numpy`` and
``train_state_from_numpy``:

* ``GroupedMatmul``'s gradients against ``jax.grad`` of the reference's
  ``einsum`` at capacities 8 and 24: the CPU's plain version under
  autograd, and the Function's own backward (two more products of the
  kernel's shape) with its launch replaced by the plain version, which
  also shows the three products' variants;
* ``lm_loss`` (total, nll, aux) and the gradient of every leaf for every
  registered family (deepseek-v3 with MTP, zamba2's rematerialized shared
  block, qwen2-vl with M-RoPE positions, hubert from frame embeddings), at
  a sequence of two attention chunks so that the query-chunk remat runs;
* three ``make_train_step`` steps with AdamW and with Adafactor,
  ``grad_accum`` 1 and 2, and M-RoPE positions split on their batch axis:
  losses, gradient norms, parameters and both moments;
* ``clip_by_global_norm``, ``cosine_schedule``, ``compress_topk`` (three
  error-feedback rounds) and ``aggregate_sparse``; ``allreduce_topk`` on 4
  spawned gloo ranks against ``tests/test_distributed.py``'s NumPy oracle
  (the reference's mesh paths fail under the installed JAX);
* the checkpoint manager (round trip, retention, an async save, a
  bfloat16 leaf, a train state) and ``train()`` interrupted (at a step
  count and by SIGTERM) and resumed, bit for bit.

Tolerances: rtol/atol 1e-5 on losses; gradients, parameters and moments
within 1e-4 of each leaf's largest magnitude (1e-6 at least, for a leaf
the reference leaves near zero).  The learning rate is the reference's
``test_train_step_decreases_loss``'s 5e-3 under the 200-step warmup, so
three Adam steps move a parameter by at most 1.5e-4: an update whose sign
an ulp of its gradient decides stays inside the bound.

The reference's jitted programs compile for seconds a case, so its results
for ``STORED_CASES`` are computed by
``scripts/make_torch_train_reference.py`` and read from
``tests/data/torch_train_reference.npz``; one case is recomputed live.
"""
import dataclasses as dc
import functools
import json
import os
import queue
import signal
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
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import compression as JC
from repro.optim import cosine_schedule as j_cosine
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch import train as TR
from repro_torch.models import model as M
from repro_torch.optim import adafactor, adamw, clip_by_global_norm, cosine_schedule
from repro_torch.optim import compression as C
from repro_torch.optim.optimizers import whole
from test_torch_baselines import one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_families import ALL_ARCHS, family_weights

import _torch_train_ranks

REFERENCE_FILE = Path(__file__).parent / "data" / "torch_train_reference.npz"
B, S = 2, 64  # two of the smoke configs' 32-position attention chunks
LR = 5e-3
GMM_CASES = {"gmm-c8": (4, 8, 24, 16), "gmm-c24": (3, 24, 16, 40)}  # E, C, D, F
STEP_CASES = {  # arch, optimizer, grad_accum
    "step-moe-adamw-1": ("qwen3-moe-30b-a3b", "adamw", 1),
    "step-moe-adafactor-1": ("qwen3-moe-30b-a3b", "adafactor", 1),
    "step-moe-adamw-2": ("qwen3-moe-30b-a3b", "adamw", 2),
    "step-vlm-adafactor-2": ("qwen2-vl-2b", "adafactor", 2),
}
N_STEPS = 3
TOPK = dict(n=4096, k=256, rounds=3)
STORED_CASES = tuple(list(GMM_CASES) + [f"loss-{a}" for a in ALL_ARCHS] + list(STEP_CASES)
                     + ["topk"])
LIVE_CASE = "gmm-c8"


def case_rng(name: str):
    return np.random.default_rng(zlib.crc32(name.encode()))


def flat(tree, prefix: str = "") -> dict:
    """A nested dict's leaves as NumPy arrays by ``/``-joined path."""
    return {k: np.asarray(v) for k, v in M.flatten_tree(tree, prefix).items()}


@functools.lru_cache(maxsize=None)
def weights(arch: str):
    """The reference's smoke config of ``arch`` and NumPy weights in its
    parameter pytree (``test_torch_families.family_weights``)."""
    cfg_j = j_get_config(arch, smoke=True)
    return cfg_j, family_weights(cfg_j, case_rng(f"train-{arch}"))


def batch_inputs(arch: str, name: str, b: int = B) -> dict:
    """Token ids (a front-end stub's (B, S, D) embeddings), labels with
    about a tenth masked (-1), and for M-RoPE (t, h, w) positions that
    differ by axis."""
    cfg_j, _ = weights(arch)
    rng = case_rng(f"{name}-inputs")
    out = {"tokens": rng.integers(0, cfg_j.vocab, (b, S)).astype(np.int32)}
    labels = rng.integers(0, cfg_j.vocab, (b, S)).astype(np.int32)
    labels[rng.random((b, S)) < 0.1] = -1
    out["labels"] = labels
    if cfg_j.frontend_stub:
        out["tokens"] = rng.normal(size=(b, S, cfg_j.d_model)).astype(np.float32)
    if cfg_j.rope == "mrope":
        out["mrope_pos"] = np.sort(rng.integers(0, 2 * S, (3, b, S)), -1).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# the reference's results
# ---------------------------------------------------------------------------


def gmm_inputs(name: str) -> dict:
    e, c, d, f = GMM_CASES[name]
    rng = case_rng(name)
    x = rng.normal(size=(e * c, d)).astype(np.float32)
    x.reshape(e, c, d)[:, c - 3:] = 0  # capacity padding
    return {"x": x, "w": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
            "dy": rng.normal(size=(e * c, f)).astype(np.float32)}


def compute_gmm(name: str) -> dict:
    """``jax.grad`` of sum(einsum("ecd,edf->ecf") * dy): dX and dW."""
    e, c, d, f = GMM_CASES[name]
    inp = gmm_inputs(name)

    def f_(x, w):
        y = jnp.einsum("ecd,edf->ecf", x.reshape(e, c, d), w).reshape(e * c, f)
        return jnp.sum(y * jnp.asarray(inp["dy"]))

    dx, dw = jax.jit(jax.grad(f_, argnums=(0, 1)))(jnp.asarray(inp["x"]), jnp.asarray(inp["w"]))
    return {"dx": np.asarray(dx), "dw": np.asarray(dw)}


def compute_loss(arch: str) -> dict:
    cfg_j, params = weights(arch)
    inp = batch_inputs(arch, f"loss-{arch}")
    mpos = None if "mrope_pos" not in inp else jnp.asarray(inp["mrope_pos"])
    fn = jax.jit(jax.value_and_grad(
        lambda p, t, l, mp: JM.lm_loss(p, cfg_j, t, l, mrope_pos=mp), has_aux=True))
    (total, met), grads = fn(params, jnp.asarray(inp["tokens"]), jnp.asarray(inp["labels"]),
                             mpos)
    return {"total": np.asarray(total), "nll": np.asarray(met["nll"]),
            "aux": np.asarray(met["aux"], np.float32), **flat(grads, "grad/")}


def compute_step(name: str) -> dict:
    """Three of the reference's train steps from zero moments: each step's
    loss and gradient norm, then the parameters and both moments."""
    arch, opt, accum = STEP_CASES[name]
    cfg_j, params = weights(arch)
    cfg_j = dc.replace(cfg_j, grad_accum=accum)
    step, _, _ = JST.make_train_step(cfg_j, optimizer=opt, lr=LR)
    init_opt = (jax_adamw_init if opt == "adamw" else jax_adafactor_init)
    m0, v0 = init_opt(params)
    state = JST.TrainState(jax.tree.map(jnp.asarray, params), m0, v0, jnp.int32(0))
    batch = {k: jnp.asarray(v) for k, v in batch_inputs(arch, name, b=2 * B).items()}
    step = jax.jit(step)
    losses, norms = [], []
    for _ in range(N_STEPS):
        state, met = step(state, batch)
        losses.append(np.asarray(met["loss"]))
        norms.append(np.asarray(met["grad_norm"]))
    return {"loss": np.stack(losses), "grad_norm": np.stack(norms),
            **flat(state.params, "params/"), **flat(state.opt_m, "m/"),
            **flat(state.opt_v, "v/")}


def jax_adamw_init(params):
    from repro.optim import adamw as j_adamw

    st = j_adamw()[0](params)
    return st.m, st.v


def jax_adafactor_init(params):
    from repro.optim import adafactor as j_adafactor

    st = j_adafactor()[0](params)
    return st.m, st.v


def topk_inputs() -> np.ndarray:
    rng = case_rng("topk")
    return rng.normal(size=(TOPK["rounds"], TOPK["n"])).astype(np.float32)


def compute_topk(name: str) -> dict:
    """``compress_topk`` over the rounds' gradients with error feedback, then
    ``aggregate_sparse`` over every round's pairs."""
    grads = topk_inputs()
    st = JC.init_topk(jnp.asarray(grads[0]))
    out, idx_all, val_all = {}, [], []
    for r, g in enumerate(grads):
        idx, val, st = JC.compress_topk(jnp.asarray(g), st, TOPK["k"])
        out[f"idx{r}"], out[f"val{r}"] = np.asarray(idx), np.asarray(val)
        out[f"residual{r}"] = np.asarray(st.residual)
        idx_all.append(idx)
        val_all.append(val)
    out["dense"] = np.asarray(JC.aggregate_sparse(jnp.concatenate(idx_all),
                                                  jnp.concatenate(val_all), TOPK["n"]))
    return out


def compute(name: str) -> dict[str, np.ndarray]:
    """The reference's arrays of case ``name``."""
    if name in GMM_CASES:
        return compute_gmm(name)
    if name.startswith("loss-"):
        return compute_loss(name[len("loss-"):])
    if name in STEP_CASES:
        return compute_step(name)
    return compute_topk(name)


@functools.lru_cache(maxsize=1)
def _stored_arrays():
    return np.load(REFERENCE_FILE)


def stored(name: str) -> dict[str, np.ndarray]:
    arrays = _stored_arrays()
    got = {k.split("|", 1)[1]: arrays[k] for k in arrays.files if k.startswith(f"{name}|")}
    if not got:
        pytest.fail(f"{REFERENCE_FILE.name} has no case {name!r}: run "
                    "scripts/make_torch_train_reference.py")
    return got


def test_stored_reference_is_the_reference_output():
    """One case recomputed live through the JAX package equals the stored
    file bit for bit (the script's ``--check`` recomputes all)."""
    got, want = compute(LIVE_CASE), stored(LIVE_CASE)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def close_leaf(got, want, name: str, tol: float = 1e-4) -> None:
    """Within ``tol`` of the leaf's largest magnitude (at least 1e-6)."""
    want = np.asarray(want, np.float32)
    got = _np(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bound = tol * max(float(np.abs(want).max(initial=0.0)), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=name)


def close_scalar(got, want, name: str) -> None:
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=1e-5, atol=1e-5,
                               err_msg=name)


# ---------------------------------------------------------------------------
# the grouped matmul's backward
# ---------------------------------------------------------------------------


def _gmm_grads(name: str, fn):
    e, c, d, f = GMM_CASES[name]
    inp = gmm_inputs(name)
    x = torch.from_numpy(inp["x"]).requires_grad_()
    w = torch.from_numpy(inp["w"]).requires_grad_()
    y = fn(x, w, c)
    assert y.shape == (e * c, f)
    (y * torch.from_numpy(inp["dy"])).sum().backward()
    return x.grad, w.grad


@pytest.mark.parametrize("name", list(GMM_CASES))
def test_grouped_matmul_plain_gradients_match_reference(name):
    """On the CPU the grouped matmul is the plain version, differentiated by
    autograd."""
    want = stored(name)
    dx, dw = _gmm_grads(name, lambda x, w, c: ops.moe_grouped_matmul(x, w, capacity=c))
    close_leaf(dx, want["dx"], "dx", 1e-5)
    close_leaf(dw, want["dw"], "dw", 1e-5)


@pytest.fixture
def plain_launch(monkeypatch):
    """``grouped_matmul_launch`` replaced by the plain version (on the CPU),
    holding the launch's contract (contiguous tensors of one dtype, x (E*C,
    D), w (E, D, F)) and recording each call's (rows, D, F, capacity,
    variant)."""
    calls = []

    def launch(x, w, *, capacity):
        assert x.is_contiguous() and w.is_contiguous() and x.dtype == w.dtype
        e, d, f = w.shape
        assert x.shape == (e * capacity, d)
        name = gm.variant(x.dtype, d, f, capacity)[0]
        calls.append((x.shape[0], d, f, capacity, name))
        return gm.grouped_matmul_plain(x, w, capacity=capacity), name

    monkeypatch.setattr(gm, "grouped_matmul_launch", launch)
    return calls


@pytest.mark.parametrize("name", list(GMM_CASES))
def test_grouped_matmul_function_backward_matches_reference(name, plain_launch):
    """The Function's backward is two more products of the kernel's shape:
    dX = dY (E*C, F) @ w^T (E, F, D) at capacity C, dW = x^T (E*D, C) @ dY
    (E, C, F) at capacity D; each launch is counted once, the backward's as
    such."""
    e, c, d, f = GMM_CASES[name]
    counted = []
    want = stored(name)
    dx, dw = _gmm_grads(name, lambda x, w, cap: gm.GroupedMatmul.apply(
        x, w, cap, lambda v, backward=False: counted.append((v, backward))))
    close_leaf(dx, want["dx"], "dx", 1e-5)
    close_leaf(dw, want["dw"], "dw", 1e-5)
    assert [call[:4] for call in plain_launch] == [(e * c, d, f, c), (e * c, f, d, c),
                                                   (e * d, c, f, d)]
    assert counted == [("simt", False), ("simt", True), ("simt", True)]  # float32


@pytest.mark.parametrize("name", list(GMM_CASES))
def test_grouped_matmul_function_keeps_bf16_on_the_tensor_cores(name, plain_launch):
    """In bfloat16, widths and capacities that are multiples of 8 keep all
    three products on the tensor-core variant (dW's inner width is C)."""
    inp = gmm_inputs(name)
    e, c, d, f = GMM_CASES[name]
    x = torch.from_numpy(inp["x"]).to(torch.bfloat16).requires_grad_()
    w = torch.from_numpy(inp["w"]).to(torch.bfloat16).requires_grad_()
    y = gm.GroupedMatmul.apply(x, w, c, lambda v, backward=False: None)
    y.backward(torch.from_numpy(inp["dy"]).to(torch.bfloat16))
    assert [call[4] for call in plain_launch] == ["wgmma"] * 3
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    ref = [t.detach().float().requires_grad_() for t in (x, w)]
    torch.einsum("ecd,edf->ecf", ref[0].view(e, c, d), ref[1]).reshape(e * c, f).backward(
        torch.from_numpy(inp["dy"]).to(torch.bfloat16).float())
    for got, r in zip((x.grad, w.grad), ref):  # one bfloat16 rounding of the float32 sums
        close_leaf(got, r.grad.numpy(), "bf16 grad", 2 ** -7)


# ---------------------------------------------------------------------------
# the loss and its gradients, every family
# ---------------------------------------------------------------------------


def port_model(arch: str):
    cfg_j, params = weights(arch)
    cfg = get_config(arch, smoke=True)
    assert dc.asdict(cfg) == dc.asdict(cfg_j)
    return cfg, M.trainable(M.params_from_numpy(cfg, params, device="cpu"))


def leaf_grads(model: M.Model) -> dict:
    return {k: whole(tuple(t.grad if t.grad is not None else torch.zeros_like(t) for t in
                           (leaf if isinstance(leaf, tuple) else (leaf,))))
            .reshape(whole(leaf).shape)
            for k, leaf in M.param_leaves(model).items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    cfg, model = port_model(arch)
    assert cfg.remat
    inp, want = batch_inputs(arch, f"loss-{arch}"), stored(f"loss-{arch}")
    total, met = M.lm_loss(model, cfg, torch.from_numpy(inp["tokens"]),
                           torch.from_numpy(inp["labels"]),
                           mrope_pos=None if "mrope_pos" not in inp
                           else torch.from_numpy(inp["mrope_pos"]))
    close_scalar(total, want["total"], "total")
    close_scalar(met["nll"], want["nll"], "nll")
    close_scalar(met["aux"], want["aux"], "aux")
    total.backward()
    grads = leaf_grads(model)
    assert sorted(grads) == sorted(k[len("grad/"):] for k in want if k.startswith("grad/"))
    for k, g in grads.items():
        close_leaf(g, want[f"grad/{k}"], k)


def test_masked_ce_is_the_one_hot_contraction():
    """The gather gives the reference's one-hot value; masked positions
    count for nothing, and an all-masked batch gives 0."""
    rng = case_rng("masked-ce")
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    want = JM._masked_ce(jnp.asarray(logits), jnp.asarray(labels))
    close_scalar(M._masked_ce(torch.from_numpy(logits), torch.from_numpy(labels)), want, "ce")
    assert float(M._masked_ce(torch.from_numpy(logits), torch.full((2, 5), -1))) == 0.0


def test_remat_changes_nothing_but_memory():
    """With remat off the same loss and gradients come out (the recompute
    re-runs the routing, and the stable sort gives it the same order)."""
    arch = "qwen3-moe-30b-a3b"
    inp = batch_inputs(arch, f"loss-{arch}")
    out = []
    for remat in (True, False):
        cfg, model = port_model(arch)
        cfg = dc.replace(cfg, remat=remat)
        total, _ = M.lm_loss(model, cfg, torch.from_numpy(inp["tokens"]),
                             torch.from_numpy(inp["labels"]))
        total.backward()
        out.append((total.detach(), leaf_grads(model)))
    assert torch.equal(out[0][0], out[1][0])
    for k in out[0][1]:
        torch.testing.assert_close(out[0][1][k], out[1][1][k], rtol=0, atol=1e-7)


def test_serving_keeps_parameters_without_gradients():
    cfg, model = port_model("qwen2-1.5b")
    M.trainable(model, False)
    assert not any(t.requires_grad for t in model.parameters())
    assert all(t.requires_grad for t in M.trainable(model).parameters())


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_steps_match_reference(name):
    arch, opt, accum = STEP_CASES[name]
    cfg_j, params = weights(arch)
    cfg = dc.replace(get_config(arch, smoke=True), grad_accum=accum)
    init = jax_adamw_init if opt == "adamw" else jax_adafactor_init
    m0, v0 = (jax.tree.map(np.asarray, t) for t in init(params))
    state = M.train_state_from_numpy(cfg, params, m0, v0, 0, device="cpu")
    step, _, opt_name = ST.make_train_step(cfg, optimizer=opt, lr=LR)
    assert opt_name == opt
    batch = {k: torch.from_numpy(v) for k, v in batch_inputs(arch, name, b=2 * B).items()}
    want = stored(name)
    for i in range(N_STEPS):
        state, met = step(state, batch)
        close_scalar(met["loss"], want["loss"][i], f"loss {i}")
        close_scalar(met["grad_norm"], want["grad_norm"][i], f"grad_norm {i}")
    assert state.step == N_STEPS
    for k, leaf in M.param_leaves(state.params).items():
        close_leaf(whole(leaf), want[f"params/{k}"], k)
        close_leaf(state.opt_m[k], want[f"m/{k}"], f"m {k}")
        close_leaf(state.opt_v[k], want[f"v/{k}"], f"v {k}")


def test_train_state_layout_and_default_optimizer():
    """Moments keep the reference's shapes (Adafactor's factored by the
    layer stack), and the optimizer defaults to Adafactor above 60 B
    parameters, as the reference's."""
    for opt in ("adamw", "adafactor"):
        cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
        _, init_state, _ = ST.make_train_step(cfg, optimizer=opt)
        state = init_state(torch.Generator().manual_seed(0))
        cfg_j, params = weights("qwen3-moe-30b-a3b")
        m, v = (flat(jax.tree.map(np.asarray, t)) for t in
                (jax_adamw_init if opt == "adamw" else jax_adafactor_init)(params))
        assert {k: tuple(t.shape) for k, t in state.opt_m.items()} == {
            k: a.shape for k, a in m.items()}
        assert {k: tuple(t.shape) for k, t in state.opt_v.items()} == {
            k: a.shape for k, a in v.items()}
    for arch in ALL_ARCHS:
        assert ST.default_optimizer(get_config(arch)) == JST.default_optimizer(
            j_get_config(arch))
    with pytest.raises(ValueError, match="microbatches"):
        ST._split("tokens", torch.zeros((3, 4)), 2)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def test_clip_by_global_norm_matches_reference():
    rng = case_rng("clip")
    g = {"a": rng.normal(size=(10,)).astype(np.float32) * 100,
         "b": {"c": rng.normal(size=(3, 4)).astype(np.float32)}}
    want, wnorm = j_clip(jax.tree.map(jnp.asarray, g), 1.0)
    leaves = {"a": torch.from_numpy(g["a"].copy()),  # "b/c" as a stack of its 3 rows
              "b/c": tuple(torch.from_numpy(row.copy()) for row in g["b"]["c"])}
    got, norm = clip_by_global_norm(leaves, 1.0)
    close_scalar(norm, wnorm, "norm")
    close_leaf(got["a"], want["a"], "a", 1e-6)
    close_leaf(whole(got["b/c"]), want["b"]["c"], "b/c", 1e-6)
    # below the bound nothing changes
    small = {"x": torch.full((4,), 0.1)}
    out, n = clip_by_global_norm(small, 1.0)
    assert float(n) == pytest.approx(0.2) and torch.equal(out["x"], torch.full((4,), 0.1))


@pytest.mark.parametrize("step", [0, 1, 10, 57, 100, 150])
def test_cosine_schedule_matches_reference(step):
    want = float(j_cosine(1e-3, warmup=10, total=100)(jnp.int32(step)))
    assert cosine_schedule(1e-3, 10, 100)(step) == pytest.approx(want, rel=1e-6, abs=1e-12)


def _quadratic_losses(opt, steps=60):
    init, update = opt
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 8)))
    params = {"w": torch.zeros((8, 8), dtype=torch.float64), "b": torch.zeros(8,
                                                                              dtype=torch.float64)}
    state = init(params)
    out = []
    for _ in range(steps):
        grads = {"w": 2 * (params["w"] - target), "b": 2 * params["b"]}
        params, state = update(grads, state, params)
        out.append(float(((params["w"] - target) ** 2).sum() + (params["b"] ** 2).sum()))
    return out, state


def test_optimizers_converge_on_a_quadratic():
    """``tests/test_substrate.py``'s quadratic, through the port's update
    rules."""
    losses, _ = _quadratic_losses(adamw(lr=0.05, weight_decay=0.0))
    assert losses[-1] < 0.05 * losses[0]
    losses, st = _quadratic_losses(adafactor(lr=0.3))
    assert losses[-1] < 0.2 * losses[0]
    assert st.step == 60
    st = adafactor()[0]({"w": torch.zeros((64, 128))})
    assert sum(t.numel() for t in (*st.m.values(), *st.v.values())) == 64 + 128


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


def test_compress_topk_and_aggregate_sparse_match_reference():
    want = stored("topk")
    grads = topk_inputs()
    st = C.init_topk(torch.from_numpy(grads[0]))
    idx_all, val_all = [], []
    for r, g in enumerate(grads):
        idx, val, st = C.compress_topk(torch.from_numpy(g), st, TOPK["k"])
        np.testing.assert_array_equal(idx.numpy(), want[f"idx{r}"].astype(np.int64))
        np.testing.assert_array_equal(val.numpy(), want[f"val{r}"])
        np.testing.assert_array_equal(st.residual.numpy(), want[f"residual{r}"])
        idx_all.append(idx)
        val_all.append(val)
    vals = torch.cat(val_all)
    dense = C.aggregate_sparse(torch.cat(idx_all), vals, TOPK["n"])
    # sums of a few float32 values in another order: 2 n 2^-24 sum|x|
    bound = 2 * vals.numel() * 2.0 ** -24 * float(vals.abs().sum())
    np.testing.assert_allclose(dense.numpy(), want["dense"], rtol=0, atol=bound)
    assert (np.bincount(torch.cat(idx_all).numpy()) > 1).any()  # the rounds repeat indices


def test_allreduce_topk_on_four_gloo_ranks(tmp_path):
    """Four spawned CPU ranks, each with its row of the gradients: every
    rank gets the oracle's sum of each rank's top-k entries, and keeps the
    rest as its residual."""
    world, n, k = 4, 1024, 256
    grads = np.random.default_rng(0).normal(size=(world, n)).astype(np.float32)
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_torch_train_ranks.rank_main,
                         args=(r, world, str(tmp_path / "rdv"), grads, k, out), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(world):
            try:
                rank, dense, extra = out.get(timeout=120)
            except queue.Empty:
                pytest.fail("a rank did not answer within 120 s")
            if dense is None:
                pytest.fail(f"rank {rank} failed:\n{extra}")
            got[rank] = (dense, extra)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    want = np.zeros(n, np.float32)
    for r, row in enumerate(grads):
        top = np.argsort(-np.abs(row))[:k]
        want[top] += row[top]
        residual = row.copy()
        residual[top] = 0.0
        np.testing.assert_array_equal(got[r][1], residual)
    for r in range(world):
        np.testing.assert_allclose(got[r][0], want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# checkpoints and the driver
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_retention_and_bf16(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "nested": {"b": torch.ones(3)},
            "h": (torch.arange(5, dtype=torch.bfloat16) / 3, 7)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save({"w": tree["w"] * step, "nested": tree["nested"], "h": tree["h"]}, step,
                 extras={"loader": {"seed": 0, "step": step}})
    assert mgr.all_steps() == [2, 3]
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    restored, manifest = mgr.restore(tree)
    assert manifest["step"] == 3 and manifest["extras"]["loader"]["step"] == 3
    assert torch.equal(restored["w"], tree["w"] * 3)
    assert restored["h"][0].dtype == torch.bfloat16 and torch.equal(restored["h"][0],
                                                                     tree["h"][0])
    assert restored["h"][1] == 7 and type(restored["h"][1]) is int
    assert manifest["leaves"]["h/0"]["dtype"] == "bfloat16"
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        assert json.load(f)["leaves"]["w"] == {"shape": [3, 4], "dtype": "float32"}
    assert mgr.restore(tree, step=2)[1]["step"] == 2


def test_checkpoint_async_save_snapshots_first(tmp_path):
    w = torch.ones((128, 128))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"w": w}, 5, blocking=False)
    w.add_(1.0)  # training goes on: the checkpoint holds the values at save()
    mgr.wait()
    assert mgr.latest_step() == 5
    assert torch.equal(mgr.restore({"w": w})[0]["w"], torch.ones((128, 128)))


def test_checkpoint_restores_a_train_state_in_place(tmp_path):
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    _, init_state, _ = ST.make_train_step(cfg)
    a = init_state(torch.Generator().manual_seed(1))._replace(step=4)
    b = init_state(torch.Generator().manual_seed(2))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(a, 4)
    got, manifest = mgr.restore(b)
    assert got.params is b.params and got.step == 4
    for (n, x), (_, y) in zip(a.params.named_parameters(), got.params.named_parameters()):
        assert torch.equal(x, y), n
    assert all(torch.equal(a.opt_v[k], got.opt_v[k]) for k in a.opt_v)


def _read_steps(d: str) -> dict:
    with np.load(os.path.join(d, "shard_p0.npz")) as z:
        return {k: z[k] for k in z.files}


def test_train_resume_bit_exact(tmp_path):
    """``tests/test_substrate.py``'s recipe on the port: 6 steps at once
    equal 3 steps, a stop and 3 more after ``resume``, the losses and the
    final checkpoints (model, moments, step, loader cursor) bit for bit."""
    kw = dict(smoke=True, batch=2, seq=32, log_every=100, device="cpu")
    full = TR.train("qwen2-1.5b", steps=6, ckpt_dir=str(tmp_path / "a"), **kw)
    TR.train("qwen2-1.5b", steps=3, ckpt_dir=str(tmp_path / "b"), save_every=3, **kw)
    resumed = TR.train("qwen2-1.5b", steps=6, ckpt_dir=str(tmp_path / "b"), resume=True,
                       save_every=100, **kw)
    assert resumed == full[3:]
    a, b = (_read_steps(str(tmp_path / d / "step_00000006")) for d in "ab")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_saves_and_stops_on_sigterm(tmp_path, monkeypatch):
    """SIGTERM during step 2 saves after it and stops; a resume finishes the
    run as if it had not stopped."""
    kw = dict(smoke=True, batch=2, seq=16, log_every=100, device="cpu")
    full = TR.train("qwen3-moe-30b-a3b", steps=4, **kw)

    class Preempted(TR.DataLoader):
        def next(self):
            if self.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().next()

    monkeypatch.setattr(TR, "DataLoader", Preempted)
    first = TR.train("qwen3-moe-30b-a3b", steps=4, ckpt_dir=str(tmp_path), **kw)
    assert len(first) == 2 and CheckpointManager(str(tmp_path)).latest_step() == 2
    monkeypatch.undo()
    rest = TR.train("qwen3-moe-30b-a3b", steps=4, ckpt_dir=str(tmp_path), resume=True, **kw)
    assert first + rest == full


def test_train_cli_and_frontend_stub(capsys):
    """The CLI on the CPU, and a front-end stub (hubert) trained from the
    driver's seeded pseudo-embeddings."""
    TR.main(["--arch", "qwen2-1.5b", "--steps", "2", "--batch", "2", "--seq", "16",
             "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "step 2: loss=" in out and "final loss" in out
    losses = TR.train("hubert-xlarge", steps=2, batch=2, seq=16, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    losses = TR.train("qwen2-vl-2b", steps=1, batch=2, seq=16, device="cpu")
    assert np.isfinite(losses).all()


def test_train_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.train("qwen2-1.5b", steps=1)

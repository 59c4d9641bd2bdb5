"""Model substrate of the port: projections, RMSNorm, RoPE and M-RoPE, GQA
and MLA attention with a chunked online softmax and the decode cache, and
MLPs (counterpart of :mod:`repro.models.layers`).

Parameters live in small ``nn.Module`` holders whose attribute paths
mirror the reference's parameter dicts (``attn.wq.kernel`` is
``p["attn"]["wq"]["kernel"]``), so ``model.params_from_numpy`` copies the
reference's weights without transposes: a projection's ``kernel`` is
``(d_in, d_out)`` and ``dense`` computes ``x @ kernel``.  Every tensor is
drawn in float32 from an explicit ``torch.Generator`` with the reference's
scale, then cast.  Each parameter carries its logical axis names (``axes``,
the reference's spec entries), from which a sharded model takes its
layout.  The reference's activation-sharding ``hint`` has no counterpart:
the port's ranks gather a sharded layer's weights instead
(:mod:`repro_torch.distributed.fsdp`).  Parameters are built without
gradients, for serving; ``model.trainable`` switches a model's on for
training.  With gradients on, the chunked attention rematerializes each
query chunk in the backward pass, as the reference's ``jax.checkpoint`` of
its ``q_step``.

On a mesh of ranks (``mesh=``, a ``sharding.NamedMesh`` with a ``"model"``
axis) a layer's decode cache is the rank's shard under
``sharding.cache_specs`` (``model.init_cache(..., mesh=)``):

* GQA K/V split by heads (where ``n_kv_heads * kv_dup`` divides the
  ``"model"`` ranks): the rank computes attention for the query heads that
  read its KV heads, and the heads' outputs are all-gathered over
  ``"model"`` before ``wo``;
* GQA K/V split by sequence (elsewhere): flash-decoding.  A new row is
  written only on the rank that owns its position; each rank computes the
  unnormalised softmax over its positions (its slice's causal offset; an
  empty or zero-padded slice weighs nothing), then one all-reduce (max) of
  the row maxima and one all-reduce (sum) of the rescaled sums and outputs
  (:func:`_combine_partials`);
* MLA's latent split by channels and its rotated key by sequence: the
  rank writes its slice of the new rows, and the layer's shards are
  all-gathered over ``"model"`` where it runs.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as SH
from repro_torch.models.config import ModelConfig


_CUT: list = [None]  # set by ``cutting``: each new parameter's shard is kept


@contextlib.contextmanager
def cutting(cut):
    """While open, :func:`param` keeps ``cut(tensor, axes)`` of each tensor
    in place of the tensor (a sharded model's draw and cut, one tensor at a
    time: no rank holds the whole model)."""
    _CUT[0] = cut
    try:
        yield
    finally:
        _CUT[0] = None


def param(t: torch.Tensor, axes: tuple) -> nn.Parameter:
    """A parameter (gradients off) with its logical axis names ``axes`` (the
    reference's spec entries for it: ``"embed"``, ``"heads"``, ..., None
    for an unnamed dimension), kept as its ``axes`` attribute."""
    if _CUT[0] is not None:
        t = _CUT[0](t, axes)
    p = nn.Parameter(t, requires_grad=False)
    p.axes = tuple(axes)
    return p


DRAW_ELEMENTS = 1 << 26  # the most elements drawn in float32 at once (256 MB)


def normal(gen: torch.Generator | None, shape, scale: float, dtype, device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 from ``gen`` and cast to
    ``dtype``; uninitialised when ``gen`` is None (weights to be copied
    in).  A tensor of more than ``DRAW_ELEMENTS`` is drawn in slices of
    its leading axis (an expert, a block of embedding rows), so the float32
    draw never holds more than that: one of deepseek-v3's expert tensors is
    7.5 GB in bfloat16 and would be a 15 GB float32 transient whole."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    shape = tuple(shape)
    if math.prod(shape) <= DRAW_ELEMENTS:
        t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return t.mul_(scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    step = max(1, DRAW_ELEMENTS // math.prod(shape[1:]))
    for lo in range(0, shape[0], step):
        part = out[lo:lo + step]
        part.copy_(torch.randn(part.shape, generator=gen, dtype=torch.float32,
                               device=device).mul_(scale))
    return out


class Dense(nn.Module):
    """``kernel`` (d_in, d_out) of logical axes ``axes`` and an optional
    ``bias`` (d_out,) of its last one, as the reference's ``make_dense``."""

    def __init__(self, d_in: int, d_out: int, *, dtype, device, gen=None, bias=False,
                 axes=("embed", "mlp")):
        super().__init__()
        self.kernel = param(normal(gen, (d_in, d_out), 1.0 / math.sqrt(max(1, d_in)), dtype,
                                   device), axes)
        self.bias = (param(torch.zeros((d_out,), dtype=dtype, device=device), axes[-1:])
                     if bias else None)


class Norm(nn.Module):
    def __init__(self, d: int, *, dtype, device, axes=("embed",)):
        super().__init__()
        self.scale = param(torch.ones((d,), dtype=dtype, device=device), axes)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.kernel
    if p.bias is not None:
        y = y + p.bias
    return y


def rmsnorm(p: Norm, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, cast back to the input's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p.scale.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# rotary position embeddings (half-split, as the reference) and M-RoPE
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (first half, second half) of each head of x (B, S,
    H, Dh) by the angles ang (B, S, Dh/2), in float32."""
    d = x.shape[-1]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1 = x[..., : d // 2].to(torch.float32)
    x2 = x[..., d // 2:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh); positions (B, S) int.  The first and second halves
    of each head are the rotated pairs (not interleaved)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)  # (B, S, d/2)


def mrope_sections(d_head: int) -> tuple[int, int, int]:
    """The (t, h, w) split of a head's d_head/2 frequencies the reference's
    attention uses: 3/8 of them each for h and w, the rest for t."""
    half = d_head // 2
    return (half - 2 * (half * 3 // 8), half * 3 // 8, half * 3 // 8)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: x (B, S, H, Dh); positions3 (3, B, S) = (t, h, w)
    ids.  The frequency spectrum is cut into three sections, each rotated
    by its own id."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to {d // 2}")
    freqs = rope_freqs(d, theta, x.device)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(positions3[i][..., None].to(torch.float32) * freqs[start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, -1))


# ---------------------------------------------------------------------------
# chunked attention (online softmax over KV chunks, a loop over Q chunks)
# ---------------------------------------------------------------------------


def _q_chunk(qblk, k, v, q0: int, causal: bool, ck: int):
    """One query chunk (B, cq, H, D) starting at position ``q0`` against
    every KV chunk of ``ck`` rows: the online softmax (scores and running
    sums in float32), the output in q's dtype."""
    b, cq, h, d = qblk.shape
    scale = 1.0 / math.sqrt(d)
    dev = qblk.device
    q_pos = q0 + torch.arange(cq, device=dev)
    m = torch.full((b, h, cq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, cq, d), dtype=torch.float32, device=dev)
    for ik in range(k.shape[1] // ck):
        kblk, vblk = k[:, ik * ck:(ik + 1) * ck], v[:, ik * ck:(ik + 1) * ck]
        s = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk).to(torch.float32) * scale
        if causal:
            k_pos = ik * ck + torch.arange(ck, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask[None, None], s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk.to(torch.float32))
        m = m_new
    l = torch.clamp_min(l, 1e-20)
    return (acc / l[..., None]).transpose(1, 2).to(qblk.dtype)  # (B, cq, H, D)


def _attn_chunked(q, k, v, *, causal: bool, q_offset: int, chunk_q: int, chunk_k: int):
    """q (B, Sq, H, D); k, v (B, Sk, H, D), already head-repeated.  Memory
    is O(chunk_q x chunk_k) per head; scores and the running sums are in
    float32, the output in q's dtype.  With gradients on and more than one
    query chunk, each chunk is recomputed in the backward pass rather than
    kept (the reference checkpoints its ``q_step`` the same way)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    cq, ck = min(chunk_q, sq), min(chunk_k, sk)
    if sq % cq or sk % ck:
        raise ValueError(f"attention lengths {sq}, {sk} do not divide into chunks {cq}, {ck}")
    nq = sq // cq
    remat = nq > 1 and torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for iq in range(nq):
        args = (q[:, iq * cq:(iq + 1) * cq], k, v, q_offset + iq * cq, causal, ck)
        outs.append(checkpoint(_q_chunk, *args, use_reentrant=False, preserve_rng_state=False)
                    if remat else _q_chunk(*args))
    return torch.cat(outs, 1)


def _partial_softmax(q, k, v, q0: int, k0: int, ck: int):
    """Unnormalised attention of q (B, Sq, H, D), at positions ``q0`` ..,
    over k, v (B, Sk, H, D) at positions ``k0`` .. (causal): ``(m, l, acc)``
    in float32, the row maxima (B, H, Sq), the sums of ``exp(s - m)`` and
    the weighted values (B, H, Sq, D).  A row whose keys are all masked
    keeps ``m = -inf`` and zero ``l`` and ``acc`` (no NaN)."""
    b, sq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    q_pos = q0 + torch.arange(sq, device=dev)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    for lo in range(0, k.shape[1], ck):
        kblk, vblk = k[:, lo:lo + ck], v[:, lo:lo + ck]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kblk).to(torch.float32) * scale
        k_pos = k0 + lo + torch.arange(kblk.shape[1], device=dev)
        s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(m - m_safe)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vblk.to(torch.float32))
        m = m_new
    return m, l, acc


def _combine_partials(mesh, m, l, acc):
    """Flash-decoding's combine over the ranks of ``mesh`` (each holding a
    slice of the positions): the global row maxima by an all-reduce (max),
    each rank's sums and outputs rescaled by ``exp(m_r - m)`` (zero for a
    rank whose slice held no visible key) and summed by one all-reduce.
    Returns the normalised output (B, H, Sq, D) float32."""
    g = SH.all_reduce(mesh, m, "max")
    scale = torch.where(torch.isfinite(m), torch.exp(m - torch.where(torch.isfinite(g), g, 0.0)),
                        0.0)
    both = torch.cat([acc * scale[..., None], (l * scale)[..., None]], -1)
    both = SH.all_reduce(mesh, both, "sum")
    return both[..., :-1] / torch.clamp_min(both[..., -1:], 1e-20)


def _tp(mesh):
    """The ``"model"`` sub-mesh of ``mesh`` where it splits a cache (more than
    one rank), else None."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh.sub("model")


def kv_split(cfg: ModelConfig, mesh) -> str | None:
    """How ``sharding.cache_specs`` splits a GQA cache over ``"model"`` on
    ``mesh``: ``"heads"``, ``"seq"``, or None (one model rank)."""
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return "heads" if (cfg.n_kv_heads * cfg.kv_dup) % mesh.shape["model"] == 0 else "seq"


def _write_owned(buf: torch.Tensor, idx: int, rows: torch.Tensor, lo: int) -> None:
    """Write ``rows`` (B, S, ...), positions ``idx`` .., into ``buf`` (B, Sb,
    ...), this rank's positions ``lo`` .. ``lo + Sb``: only the rows it owns."""
    a, b = max(idx, lo), min(idx + rows.shape[1], lo + buf.shape[1])
    if a < b:
        buf[:, a - lo:b - lo] = rows[:, a - idx:b - idx].to(buf.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, kh, d = x.shape
    return x[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(b, s, kh * n_rep, d)


def _write_rows(buf: torch.Tensor, idx: int, rows: torch.Tensor) -> None:
    """Write ``rows`` (B, S, ...) into the cache tensor ``buf`` (B, Smax,
    ...) at positions ``idx`` .. ``idx + S``."""
    if idx + rows.shape[1] > buf.shape[1]:
        raise ValueError(f"cache of {buf.shape[1]} positions cannot take {rows.shape[1]} more "
                         f"after {idx}")
    buf[:, idx:idx + rows.shape[1]] = rows.to(buf.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device, gen=None):
        super().__init__()
        d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.wq = Dense(d, h * dh, bias=cfg.qkv_bias, axes=("embed", "heads"), **kw)
        self.wk = Dense(d, kh * dh, bias=cfg.qkv_bias, axes=("embed", "kv_heads"), **kw)
        self.wv = Dense(d, kh * dh, bias=cfg.qkv_bias, axes=("embed", "kv_heads"), **kw)
        self.wo = Dense(h * dh, d, axes=("heads", "embed"), **kw)


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
              cache: dict | None = None, mrope_pos: torch.Tensor | None = None, mesh=None):
    """x (B, S, D).  ``cache``: None, or one layer's ``{"k", "v", "index"}``
    (k/v ``(B, Smax, KH, Dh)``, ``index`` the tokens already cached, a host
    integer).  The new K/V rows are written into the cache's tensors in
    place; returns ``(out, new_cache)`` with the advanced index.  An
    ``mrope`` model rotates q and k by ``mrope_pos`` (3, B, S), and, as the
    reference, not at all when it is None.  On a ``mesh`` the cache is the
    rank's shard (module docstring)."""
    b, sq, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = dense(p.wq, x).reshape(b, sq, h, dh)
    k = dense(p.wk, x).reshape(b, sq, kh, dh)
    v = dense(p.wv, x).reshape(b, sq, kh, dh)
    q = _rotated(cfg, q, positions, mrope_pos)
    k = _rotated(cfg, k, positions, mrope_pos)
    if cache is None:
        out = _attn_chunked(q, repeat_kv(k, h // kh), repeat_kv(v, h // kh), causal=cfg.causal,
                            q_offset=0, chunk_q=cfg.attn_chunk_q, chunk_k=cfg.attn_chunk_k)
        return dense(p.wo, out.reshape(b, sq, h * dh)), None
    idx = int(cache["index"])
    ck, cv = cache["k"], cache["v"]
    if cfg.kv_dup > 1:  # store duplicated kv heads, as the reference does
        k, v = repeat_kv(k, cfg.kv_dup), repeat_kv(v, cfg.kv_dup)
    split, tp = kv_split(cfg, mesh), _tp(mesh)
    if split == "seq":
        return _attention_seq(p, cfg, q, k, v, cache, tp)
    n_rep = h // (kh * cfg.kv_dup)
    if split == "heads":  # this rank's stored heads and the query heads that read them
        per = ck.shape[2]
        mine = slice(tp.rank * per, (tp.rank + 1) * per)
        q = q[:, :, tp.rank * per * n_rep:(tp.rank + 1) * per * n_rep]
        k, v = k[:, :, mine], v[:, :, mine]
    _write_rows(ck, idx, k)
    _write_rows(cv, idx, v)
    # positions past idx + sq hold zeros and are masked by the causal offset
    out = _attn_chunked(q, repeat_kv(ck.to(q.dtype), n_rep), repeat_kv(cv.to(q.dtype), n_rep),
                        causal=True, q_offset=idx, chunk_q=min(cfg.attn_chunk_q, sq),
                        chunk_k=cfg.attn_chunk_k)
    if split == "heads":
        out = SH.all_gather_tiled(tp, out, dim=2)  # (B, S, H, Dh): every head, in order
    new_cache = {"k": ck, "v": cv, "index": cache["index"] + sq}
    return dense(p.wo, out.reshape(b, sq, h * dh)), new_cache


def _rotated(cfg: ModelConfig, t: torch.Tensor, positions, mrope_pos) -> torch.Tensor:
    """q or k (B, S, H, Dh) rotated by the config's RoPE (an ``mrope`` model
    by ``mrope_pos``, and not at all when it is None, as the reference)."""
    if cfg.rope == "mrope":
        if mrope_pos is None:
            return t
        return apply_mrope(t, mrope_pos, cfg.rope_theta, sections=mrope_sections(t.shape[-1]))
    if cfg.rope == "rope":
        return apply_rope(t, positions, cfg.rope_theta)
    return t


def _attention_seq(p: Attention, cfg: ModelConfig, q, k, v, cache: dict, tp) -> tuple:
    """The sequence-split cache (flash-decoding): this rank's positions
    ``rank * Sb`` .. of ``(B, Sb, KH * kv_dup, Dh)``; q, k, v already rotated
    (k, v duplicated ``kv_dup`` times)."""
    b, sq, h, dh = q.shape
    idx = int(cache["index"])
    ck, cv = cache["k"], cache["v"]
    sb = ck.shape[1]
    if idx + sq > sb * tp.world:
        raise ValueError(f"cache of {sb * tp.world} positions cannot take {sq} more after {idx}")
    lo = tp.rank * sb
    _write_owned(ck, idx, k, lo)
    _write_owned(cv, idx, v, lo)
    n_rep = h // ck.shape[2]
    m, l, acc = _partial_softmax(q, repeat_kv(ck.to(q.dtype), n_rep),
                                 repeat_kv(cv.to(q.dtype), n_rep), idx, lo,
                                 min(cfg.attn_chunk_k, sb))
    out = _combine_partials(tp, m, l, acc).transpose(1, 2).to(q.dtype)  # (B, S, H, Dh)
    new_cache = {"k": ck, "v": cv, "index": cache["index"] + sq}
    return dense(p.wo, out.reshape(b, sq, h * dh)), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


class MLA(nn.Module):
    """``wq_a`` (D, q_lora), ``q_norm``, ``wq_b`` (q_lora, H*(nope+rope)),
    ``wkv_a`` (D, kv_lora+rope), ``kv_norm``, ``wkv_b`` (kv_lora,
    H*(nope+v)), ``wo`` (H*v, D): the reference's ``make_mla``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, gen=None):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq_a = Dense(d, m.q_lora_rank, gen=gen, axes=("embed", "lora"), **kw)
        self.q_norm = Norm(m.q_lora_rank, axes=("lora",), **kw)
        self.wq_b = Dense(m.q_lora_rank, h * qk, gen=gen, axes=("lora", "heads"), **kw)
        self.wkv_a = Dense(d, m.kv_lora_rank + m.qk_rope_head_dim, gen=gen,
                           axes=("embed", "lora"), **kw)
        self.kv_norm = Norm(m.kv_lora_rank, axes=("lora",), **kw)
        self.wkv_b = Dense(m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim), gen=gen,
                           axes=("lora", "heads"), **kw)
        self.wo = Dense(h * m.v_head_dim, d, gen=gen, axes=("heads", "embed"), **kw)


def mla_attention(p: MLA, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
                  cache: dict | None = None, mesh=None):
    """DeepSeek-V3 MLA, the reference's math (no absorbed projections).
    ``cache``: None, or one layer's ``{"latent" (B, Smax, kv_lora), "k_rope"
    (B, Smax, rope), "index"}``: the compressed latent and the rotated key
    part, written in place.  Every call expands the whole latent through
    ``wkv_b`` into K and V, pads V to the qk width for the chunked softmax
    and slices it after.  Returns ``(out, new_cache)``.  On a ``mesh`` the
    cache is the rank's shard: the latent's channels and the rotated key's
    positions (module docstring)."""
    m = cfg.mla
    b, sq, _ = x.shape
    h = cfg.n_heads
    nope, rope, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    q = dense(p.wq_b, rmsnorm(p.q_norm, dense(p.wq_a, x), cfg.norm_eps))
    q = q.reshape(b, sq, h, nope + rope)
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kv_a = dense(p.wkv_a, x)  # (B, S, kv_lora + rope)
    latent = rmsnorm(p.kv_norm, kv_a[..., :m.kv_lora_rank], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)  # (B, S, 1, rope)
    new_cache, q_offset = None, 0
    if cache is not None:
        q_offset = int(cache["index"])
        lat, kr = cache["latent"], cache["k_rope"]
        new_cache = {"latent": lat, "k_rope": kr, "index": cache["index"] + sq}
        tp = _tp(mesh)
        if tp is not None:
            lat, kr = _mla_write_gather(lat, kr, q_offset, latent, k_rope[:, :, 0], tp)
        else:
            _write_rows(lat, q_offset, latent)
            _write_rows(kr, q_offset, k_rope[:, :, 0])
        latent, k_rope = lat.to(x.dtype), kr[:, :, None].to(x.dtype)
    kv = dense(p.wkv_b, latent).reshape(b, -1, h, nope + dv)
    sk = kv.shape[1]
    k = torch.cat([kv[..., :nope], k_rope.expand(b, sk, h, rope)], -1)
    vpad = F.pad(kv[..., nope:], (0, nope + rope - dv))
    out = _attn_chunked(torch.cat([q[..., :nope], q_rope], -1), k, vpad, causal=cfg.causal,
                        q_offset=q_offset, chunk_q=min(cfg.attn_chunk_q, sq),
                        chunk_k=cfg.attn_chunk_k)[..., :dv]
    return dense(p.wo, out.reshape(b, sq, h * dv)), new_cache


def _mla_write_gather(lat, kr, idx: int, latent, k_rope, tp):
    """MLA's sharded cache: write this rank's channels of the new latent
    rows and its positions of the new rotated-key rows into its shards,
    then the layer's whole cache, all-gathered over ``"model"`` (trimmed
    of the shards' zero padding): ``(latent (B, Smax, kv_lora), k_rope
    (B, Smax, rope))``."""
    c = latent.shape[-1]
    cb = lat.shape[-1]
    lo = min(tp.rank * cb, c)
    hi = min(lo + cb, c)
    _write_rows(lat[..., :hi - lo], idx, latent[..., lo:hi])
    smax = lat.shape[1]
    if idx + latent.shape[1] > smax:
        raise ValueError(f"cache of {smax} positions cannot take {latent.shape[1]} more after "
                         f"{idx}")
    _write_owned(kr, idx, k_rope, tp.rank * kr.shape[1])
    whole_lat = SH.all_gather_tiled(tp, lat, dim=2)[..., :c]
    whole_kr = SH.all_gather_tiled(tp, kr, dim=1)[:, :smax]
    return whole_lat, whole_kr


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, act: str, *, dtype, device, gen=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, gen=gen)
        self.wi = Dense(d, d_ff, axes=("embed", "mlp"), **kw)
        self.wg = Dense(d, d_ff, axes=("embed", "mlp"), **kw) if act == "swiglu" else None
        self.wo = Dense(d_ff, d, axes=("mlp", "embed"), **kw)


def mlp(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return dense(p.wo, F.silu(dense(p.wg, x)) * dense(p.wi, x))
    return dense(p.wo, F.gelu(dense(p.wi, x), approximate="tanh"))  # jax.nn.gelu's default

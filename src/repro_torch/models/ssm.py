"""Mamba2 of the port: the state-space-duality (SSD) block, its chunked
scan and its one-token decode step (counterpart of :mod:`repro.models.ssm`).

The SSD scan cuts the sequence into chunks; inside a chunk the output is
a masked, decay-weighted product, and across chunks a (B, H, P, N) float32
state is carried, a loop over chunks like the reference's ``lax.scan``:
the blocked scan with a carry that the paper's run generation is too.

Shapes follow the reference: d_inner = expand * d_model, heads of
``head_dim``, a state of ``d_state`` per head, B and C shared by the heads
of a group (``n_groups``).  ``A_log``, ``D`` and ``dt_bias`` are float32
whatever the model's dtype, as the reference keeps them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Dense, Norm, dense, normal, param, rmsnorm


class Mamba2(nn.Module):
    """``in_proj`` (D, 2*di + 2*G*N + H) giving z, x, B, C and dt;
    ``conv_w`` (K, di + 2*G*N) and ``conv_b``; ``A_log``, ``D``,
    ``dt_bias`` (H,) float32; ``norm`` (di,); ``out_proj`` (di, D): the
    reference's ``make_mamba2``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, gen=None):
        super().__init__()
        s = cfg.ssm
        d, di, nh = cfg.d_model, cfg.d_inner_ssm, cfg.n_ssm_heads
        gn = s.n_groups * s.d_state
        kw = dict(dtype=dtype, device=device)
        self.in_proj = Dense(d, 2 * di + 2 * gn + nh, gen=gen, axes=("embed", "inner"), **kw)
        self.out_proj = Dense(di, d, gen=gen, axes=("inner", "embed"), **kw)
        conv_dim = di + 2 * gn
        self.conv_w = param(normal(gen, (s.d_conv, conv_dim), 1.0 / math.sqrt(s.d_conv), **kw),
                            (None, "inner"))
        self.conv_b = param(torch.zeros((conv_dim,), **kw), ("inner",))
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = param(torch.log(torch.linspace(1.0, 16.0, nh, **f32)), ("inner",))
        self.D = param(torch.ones((nh,), **f32), ("inner",))
        self.dt_bias = param(torch.zeros((nh,), **f32), ("inner",))
        self.norm = Norm(di, axes=("inner",), **kw)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (K, C): a depthwise causal convolution by shifted
    adds, as the reference computes it."""
    k, s = w.shape[0], x.shape[1]
    y = x * w[-1]
    for i in range(1, k):
        y = y + F.pad(x, (0, 0, i, 0))[:, :s] * w[-1 - i]
    return y + b


def _ssd_chunked(x, dt, A, B, C, chunk: int, ssm_state=None):
    """The SSD scan by blocks.  x (b, l, h, p); dt (b, l, h) float32,
    already softplus'd; A (h,) negative; B, C (b, l, g, n).  Returns y (b,
    l, h, p) in x's dtype and the final state (b, h, p, n) float32.  One
    chunk's (c x c) decay matrix is live at a time."""
    b, l, h, pdim = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"sequence length {l} is not a multiple of the SSD chunk {chunk}")
    rep = h // g
    x32 = x.to(torch.float32)
    Bh = B.to(torch.float32).repeat_interleave(rep, dim=2)  # (b, l, h, n)
    Ch = C.to(torch.float32).repeat_interleave(rep, dim=2)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = (torch.zeros((b, h, pdim, n), dtype=torch.float32, device=x.device)
             if ssm_state is None else ssm_state.to(torch.float32))
    ys = []
    for lo in range(0, l, chunk):
        xz, dz = x32[:, lo:lo + chunk], dt[:, lo:lo + chunk]
        Bz, Cz = Bh[:, lo:lo + chunk], Ch[:, lo:lo + chunk]
        dA_cum = torch.cumsum(dz * A[None, None, :], dim=1)  # (b, c, h)
        # L[i, j] = exp(cum_i - cum_j) for i >= j, masked before the exp
        seg = dA_cum[:, :, None, :] - dA_cum[:, None, :, :]  # (b, c, c, h)
        lmat = torch.exp(torch.where(causal[None, :, :, None], seg, -math.inf))
        scores = torch.einsum("bihn,bjhn->bijh", Cz, Bz)
        y_diag = torch.einsum("bijh,bjhp->bihp", scores * lmat * dz[:, None, :, :], xz)
        # the entering state's contribution
        y_off = torch.einsum("bchn,bhpn->bchp", Cz * torch.exp(dA_cum)[..., None], state)
        decay_to_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)
        contrib = torch.einsum("bchn,bchp->bhpn", Bz * (decay_to_end * dz)[..., None], xz)
        state = state * torch.exp(dA_cum[:, -1, :])[:, :, None, None] + contrib
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, 1), state


def mamba2_block(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, *, cache: dict | None = None):
    """x (B, S, D) -> ``(out (B, S, D), new_cache)``.  Three modes:

    * no cache: the chunked scan from a zero state (``new_cache`` None);
    * a cache and S > 1 (prefill): the chunked scan from the cached state;
      the new cache holds the last K-1 raw (pre-convolution) inputs in the
      cache's dtype and the final state;
    * a cache and S == 1 (decode): the convolution over the cached window
      and the recurrence ``state <- state * exp(A dt) + dt B x``.

    ``cache`` is one layer's ``{"conv" (B, K-1, conv_dim), "ssm" (B, H, P,
    N) float32}``; the new cache's tensors are new ones, as the
    reference's (a decode step keeps the window in the promoted dtype of
    the cache and the inputs)."""
    s = cfg.ssm
    b, l, _ = x.shape
    di, nh, gn = cfg.d_inner_ssm, cfg.n_ssm_heads, s.n_groups * s.d_state
    z, xbc, dt = torch.split(dense(p.in_proj, x), [di, di + 2 * gn, nh], dim=-1)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)  # (b, l, nh)
    A = -torch.exp(p.A_log)
    decode = cache is not None and l == 1
    if decode:
        window = torch.cat([cache["conv"], xbc], 1)  # (b, K, conv_dim)
        new_conv = window[:, 1:]
        xbc = (window * p.conv_w[None]).sum(1, keepdim=True) + p.conv_b
    else:
        raw_xbc = xbc
        xbc = _causal_conv(xbc, p.conv_w, p.conv_b)
    xin, B, C = torch.split(F.silu(xbc), [di, gn, gn], dim=-1)
    xin = xin.reshape(b, l, nh, s.head_dim)
    B = B.reshape(b, l, s.n_groups, s.d_state)
    C = C.reshape(b, l, s.n_groups, s.d_state)
    new_cache = None
    if not decode:
        y, final = _ssd_chunked(xin, dt, A, B, C, min(s.chunk, l),
                                ssm_state=None if cache is None else cache["ssm"])
        if cache is not None:
            new_cache = {"conv": raw_xbc[:, -(s.d_conv - 1):].to(cache["conv"].dtype),
                         "ssm": final.to(cache["ssm"].dtype)}
    else:
        rep = nh // s.n_groups
        dt1 = dt[:, 0]  # (b, nh)
        B1 = B[:, 0].to(torch.float32).repeat_interleave(rep, dim=1)  # (b, nh, n)
        C1 = C[:, 0].to(torch.float32).repeat_interleave(rep, dim=1)
        x1 = xin[:, 0].to(torch.float32)  # (b, nh, p)
        st = cache["ssm"].to(torch.float32) * torch.exp(dt1 * A[None, :])[:, :, None, None]
        st = st + dt1[:, :, None, None] * x1[..., None] * B1[:, :, None, :]
        y = torch.einsum("bhpn,bhn->bhp", st, C1)[:, None].to(x.dtype)
        new_cache = {"conv": new_conv, "ssm": st.to(cache["ssm"].dtype)}
    skip = (p.D[None, None, :, None] * xin.to(torch.float32)).to(x.dtype)
    y = y.reshape(b, l, di) + skip.reshape(b, l, di)
    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    return dense(p.out_proj, y), new_cache

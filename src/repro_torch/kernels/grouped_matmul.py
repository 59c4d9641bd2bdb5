"""Expert-blocked (grouped) matmul of the sorted MoE dispatch: the CUDA
kernel of ``csrc/grouped_matmul.cu`` and its plain version.

Counterpart of :mod:`repro.kernels.grouped_matmul` (reached through
``ops.moe_grouped_matmul``): ``out[e*C + i] = x[e*C + i] @ w[e]`` for the
capacity-padded, expert-contiguous rows x ``(E*C, D)`` and the expert
weights w ``(E, D, F)``, bfloat16 or float32 in, float32 accumulation, the
output in x's dtype.  Any capacity C works: a kernel's tiles never
straddle two experts, so the TPU kernel's ``C % block_m == 0`` rule (a TPU
tiling rule) has no counterpart.

The kernel has two variants (:func:`variant`): bfloat16 with D and F
multiples of 8 runs on the tensor cores (``wgmma``, operands staged by
TMA); float32, and bfloat16 widths TMA cannot take, run on the CUDA cores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"simt": 0, "wgmma": 1}
_ARGS = [_build.P, _build.P, _build.P, _build.LL, _build.LL, _build.LL, _build.LL, _build.I,
         _build.I, _build.I, _build.P]


def variant(dtype: torch.dtype, d: int, f: int, c: int, *, aligned: bool = True):
    """``(name, tile)`` of the kernel variant that takes an ``(E*c, d) @ (E,
    d, f)`` product: ``("wgmma", N tile)`` on the tensor cores for bfloat16
    with ``d`` and ``f`` multiples of 8 (TMA's 16-byte strides) and 16-byte
    aligned tensors, else ``("simt", row tile)`` on the CUDA cores.  The
    tensor cores' N tile is the smallest power of two from 8 to 256 that
    covers ``c`` (256 in several tiles above); the CUDA cores' row tile the
    smallest of 8, 16, 32 or 64.  The wrapper passes this choice to the C
    entry point, which refuses a tensor-core launch its inputs do not
    allow."""
    if dtype == torch.bfloat16 and d > 0 and d % 8 == 0 and f % 8 == 0 and aligned:
        n = 8
        while n < 256 and n < c:
            n *= 2
        return "wgmma", n
    return "simt", next(t for t in (8, 16, 32, 64) if c <= t or t == 64)


def _check_shapes(x: torch.Tensor, w: torch.Tensor, capacity: int) -> None:
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"grouped matmul of x {tuple(x.shape)} and w {tuple(w.shape)}: "
                         "expected x (E*C, D) and w (E, D, F)")
    e, d, _ = w.shape
    if x.shape != (e * capacity, d):
        raise ValueError(f"x {tuple(x.shape)} is not (E*C, D) = ({e}*{capacity}, {d}) for w "
                         f"{tuple(w.shape)}")


PLAIN_BLOCK_ELEMENTS = 1 << 28  # the most weights cast to float32 at once (1 GB)


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """``einsum("ecd,edf->ecf")`` in float32, cast back to x's dtype.  A
    bfloat16 ``w`` is cast a block of experts at a time (at most
    ``PLAIN_BLOCK_ELEMENTS`` weights), so the float32 copy stays bounded:
    deepseek-v3's (256, 7168, 2048) expert tensor would be 15 GB whole."""
    _check_shapes(x, w, capacity)
    e, d, f = w.shape
    xs = x.reshape(e, capacity, d).to(torch.float32)
    if w.dtype == torch.float32:
        out = torch.einsum("ecd,edf->ecf", xs, w)
    else:
        step = max(1, PLAIN_BLOCK_ELEMENTS // max(1, d * f))
        out = torch.cat([torch.einsum("ecd,edf->ecf", xs[lo:lo + step],
                                      w[lo:lo + step].to(torch.float32))
                         for lo in range(0, max(e, 1), step)])
    return out.reshape(e * capacity, f).to(x.dtype)


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor, *, capacity: int) -> torch.Tensor:
    """Launch the grouped-matmul kernel on contiguous CUDA tensors of one
    dtype (bfloat16 or float32), in the variant :func:`variant` names.  An
    empty output launches nothing."""
    return grouped_matmul_launch(x, w, capacity=capacity)[0]


def grouped_matmul_launch(x: torch.Tensor, w: torch.Tensor, *,
                          capacity: int) -> tuple[torch.Tensor, str | None]:
    """:func:`grouped_matmul_cuda`'s output and the name of the variant it
    launched (None for an empty output)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"grouped matmul: dtype {x.dtype} is not bfloat16 or float32")
    _build.check(x, x.dtype, "x", ndim=2)
    _build.check(w, x.dtype, "w", ndim=3, device=x.device)
    _check_shapes(x, w, capacity)
    e, d, f = w.shape
    out = torch.empty((e * capacity, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, None
    name, tile = variant(x.dtype, d, f, capacity, aligned=is_aligned(x, w))
    fn = _build.fn("grouped_matmul", "repro_grouped_matmul", _ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, capacity, d, f, _DTYPES[x.dtype],
             _VARIANTS[name], tile, _build.stream_of(x))
    _build.raise_on(err, "grouped_matmul")
    return out, name


class GroupedMatmul(torch.autograd.Function):
    """The kernel with a backward of its own kernel, for CUDA tensors:
    ``GroupedMatmul.apply(x, w, capacity, count)``.  ``count(variant)`` is
    called with the variant of each launch, forward and backward alike
    (the ``ops`` wrapper counts them).  For ``out = x @ w`` per expert and
    the output's gradient dY ``(E*C, F)``:

    * dX ``(E*C, D)`` is the same product of dY with ``w[e].T``: the
      kernel on ``(E*C, F) @ (E, F, D)`` at capacity C;
    * dW ``(E, D, F)`` is ``x[e].T @ dY[e]``: the kernel on the experts'
      transposed activations ``(E*D, C)`` times dY as ``(E, C, F)`` at
      capacity D, whose output ``(E*D, F)`` is dW.

    The transposed operands are contiguous copies; both products run on
    the variant :func:`variant` picks for their widths (C is a multiple of
    8 by the sorted dispatch's capacity rule, so bfloat16 stays on the
    tensor cores)."""

    @staticmethod
    def forward(ctx, x, w, capacity: int, count):
        ctx.save_for_backward(x, w)
        ctx.capacity, ctx.count = capacity, count
        out, name = grouped_matmul_launch(x, w, capacity=capacity)
        count(name)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        e, d, f = w.shape
        c = ctx.capacity
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx, name = grouped_matmul_launch(dy, w.transpose(1, 2).contiguous(), capacity=c)
            ctx.count(name, backward=True)
        if ctx.needs_input_grad[1]:
            xt = x.reshape(e, c, d).transpose(1, 2).contiguous().reshape(e * d, c)
            dw, name = grouped_matmul_launch(xt, dy.reshape(e, c, f), capacity=d)
            ctx.count(name, backward=True)
            dw = dw.reshape(e, d, f)
        return dx, dw, None, None


def is_aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)

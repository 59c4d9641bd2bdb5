"""Pipeline parallelism (GPipe) over a mesh axis (counterpart of
:mod:`repro.distributed.pipeline`).

The axis's ranks are ``stages`` pipeline stages, each holding its
``n_layers / stages`` contiguous layers.  The batch streams through as
``microbatches`` microbatches: the schedule has ``microbatches + stages -
1`` steps; at step t stage 0 takes microbatch t, every other stage the
activations its predecessor sent at step t - 1 (a ``ppermute``), and the
last stage keeps microbatch ``t - stages + 1`` when it finishes.  Stage s
works at steps ``s .. s + microbatches - 1`` and sends zeros outside them
(the reference computes its bubble steps on stale buffers and discards
them).  The outputs reach every stage by a psum of the last stage's buffer
(zeros elsewhere).

The backward is the schedule run backwards, inside one autograd
``Function``: step by step from the last, each stage recomputes its layers
from the input it saved (the stage is rematerialized), takes their
gradients, and sends its input's gradient to its predecessor by the
reverse ``ppermute``.  So every rank makes the same collectives in the
same order whatever its data: eager autograd would skip the backward of a
collective whose output this rank's loss does not reach (stage 0's
received buffers), and the ranks that did not skip it would wait forever.
Gradients follow the reference's ``shard_map`` convention
(:mod:`.sharding`): the output is one value over the stages, and the
input's gradient is the sum of the stages' (stage 0's).  The bubble is
``stages - 1`` of the ``microbatches + stages - 1`` steps
(:func:`bubble_fraction`).
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding


def bubble_fraction(stages: int, microbatches: int) -> float:
    return (stages - 1) / (microbatches + stages - 1)


class _Schedule(torch.autograd.Function):
    """``(params_stage, xmb (M, mb, ...), pipe) -> (M, mb, ...)``: the
    schedule's psum'd outputs; the backward as the module docstring says.
    Autograd is off inside both, so the collectives called there record
    nothing."""

    @staticmethod
    def forward(ctx, params, xmb, pipe):
        ring, me, last = pipe.ring, pipe.ring.rank, pipe.ring.world - 1
        inflight, inputs, finished = torch.zeros_like(xmb[0]), [], []
        for t in range(pipe.steps):
            if pipe.active(t):
                h_in = xmb[t] if me == 0 else inflight
                inputs.append(h_in)
                h_out = pipe.stage(params, h_in)
                if me == last:
                    finished.append(h_out)
            else:
                h_out = torch.zeros_like(inflight)
            if t < pipe.steps - 1:
                inflight = sharding.ppermute(ring, h_out)
        outputs = torch.stack(finished) if me == last else torch.zeros_like(xmb)
        ctx.pipe = pipe
        ctx.save_for_backward(params, *inputs)
        return sharding.all_reduce(ring, outputs, "sum")

    @staticmethod
    def backward(ctx, g_out):
        pipe = ctx.pipe
        ring, me, last = pipe.ring, pipe.ring.rank, pipe.ring.world - 1
        params, *inputs = ctx.saved_tensors
        g = sharding.all_reduce(ring, g_out, "sum")  # psum's transpose
        g_params = torch.zeros_like(params)
        g_x = torch.zeros_like(g)
        p = params.detach().requires_grad_(params.requires_grad)
        g_recv = torch.zeros_like(g[0])  # this step's output gradient from the successor
        for t in reversed(range(pipe.steps)):
            g_send = torch.zeros_like(g_recv)
            if pipe.active(t):
                g_h = g_recv + g[t - last] if me == last else g_recv
                h_in = inputs.pop().detach().requires_grad_(True)
                with torch.enable_grad():
                    h_out = pipe.stage(p, h_in)
                wrt = (h_in, p) if p.requires_grad else (h_in,)
                grads = torch.autograd.grad(h_out, wrt, g_h)
                if p.requires_grad:
                    g_params += grads[1]
                if me == 0:
                    g_x[t] = grads[0]
                else:
                    g_send = grads[0]
            if t > 0:
                g_recv = sharding.ppermute(ring, g_send, -1)
        return (g_params if ctx.needs_input_grad[0] else None,
                g_x if ctx.needs_input_grad[1] else None, None)


class _Pipe:
    def __init__(self, ring, apply_layer, per_stage: int, microbatches: int):
        self.ring, self.apply_layer = ring, apply_layer
        self.per_stage, self.microbatches = per_stage, microbatches
        self.steps = microbatches + ring.world - 1

    def active(self, t: int) -> bool:
        return 0 <= t - self.ring.rank < self.microbatches

    def stage(self, params, h):
        for layer in range(self.per_stage):
            h = self.apply_layer(params[layer], h)
        return h


def make_pipeline(mesh, apply_layer, n_layers: int, axis: str = "pod", *, microbatches: int):
    """``apply_layer(params_l, x) -> x``.  Returns ``fn(params_stage, x)``:
    ``params_stage`` this stage's ``(n_layers / stages, ...)`` layers (the
    reference's ``P(axis)`` of the stacked parameters), ``x`` (B, ...) the
    whole batch on every stage (stage 0 reads it); returns the model's (B,
    ...) output on every stage."""
    ring = mesh.sub(axis)
    if n_layers % ring.world:
        raise ValueError(f"{n_layers} layers do not split into {ring.world} stages")
    pipe = _Pipe(ring, apply_layer, n_layers // ring.world, microbatches)

    def run(params_stage, x_all: torch.Tensor) -> torch.Tensor:
        if params_stage.shape[0] != pipe.per_stage:
            raise ValueError(f"stage parameters hold {params_stage.shape[0]} layers, "
                             f"expected {pipe.per_stage}")
        b = x_all.shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        grad = torch.is_grad_enabled()
        if grad:
            x_all = sharding.replicated_input(ring, x_all)
        xmb = x_all.reshape((microbatches, b // microbatches) + x_all.shape[1:])
        out = _Schedule.apply(params_stage, xmb, pipe).reshape(x_all.shape)
        return sharding.replicated_output(ring, out) if grad else out

    return run

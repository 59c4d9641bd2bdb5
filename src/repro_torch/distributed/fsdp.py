"""Parameters sharded by the logical-axis rules over a mesh of ranks, and
gathered where a layer uses them (FSDP/ZeRO-3 over ``"data"``, the
``"model"`` axis's splits as the reference's rules lay them out).

The reference leaves this to GSPMD: its parameters and moments are global
arrays placed by ``NamedSharding`` and the compiler inserts the gathers
and reduce-scatters.  The port is SPMD: each rank holds
``sharding.shard_of`` of every leaf under
``tree_specs(logical_axes(cfg), rules_for_mesh(mesh))`` (a model built by
``model.init(..., mesh=, sharded=True)``, ``params_from_numpy`` or
``train_state_from_numpy`` with ``mesh=``), and a :class:`Layout` attached
to the model as ``model.layout`` gathers them:

* in the forward, a block's leaves are all-gathered over the axes their
  spec names when the block first reads them (:meth:`Layout.view`: a
  lazy, read-only stand-in for the module), inside the block's
  rematerialized function, so the recompute gathers them again and no
  block's gathered weights outlive its use;
* ``sorted_ep`` MoE layers keep their experts and router columns split
  over ``"model"`` (the expert-parallel slice): only their ``"data"``
  split is gathered;
* in the backward each gradient arrives as the rank's shard.

The gradient convention is the one of the expert-parallel block (see
``sharding``'s comment on ``shard_map`` gradients): the ranks of
``"model"`` repeat their data rank's dense compute, each holding the
whole gradient of its data shard's loss.  So a leaf's gradient is the sum
over the data ranks of their cotangents; the ``"model"`` ranks are not
summed where the leaf is split over ``"model"`` (each block's owner uses
its own copy), and where the leaf is replicated over ``"model"`` they are
averaged, so that its copies stay equal.  Gloo has no reduce-scatter: the
backward all-reduces the slab of the cotangent the rank's block lies in
and keeps the block.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn

from repro_torch.distributed import sharding as SH

# an expert-parallel MoE layer's leaves that stay split over "model"
EP_LEAVES = ("moe.wi", "moe.wg", "moe.wo", "moe.router.kernel")


class Layout:
    """Where every parameter of a sharded model lives: its ``specs`` and
    global ``shapes`` by parameter name, on ``mesh``.  ``ep``: the MoE
    layers run ``sorted_ep`` (their expert dimension stays split over
    ``"model"``).  ``batch_split``: the data ranks each run their shard of
    the batch (the default); False while :func:`whole_batch` is open."""

    def __init__(self, mesh, axes: dict, shapes: dict, *, ep: bool):
        self.mesh = mesh
        self.rules = SH.rules_for_mesh(mesh)
        self.specs = {n: SH.spec_from_axes(a, self.rules) for n, a in axes.items()}
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.ep = ep
        self.dp_axes = tuple(a for a in SH.DATA_AXES if a in mesh.axis_names)
        self.batch_split = True
        self.prefix: dict[int, str] = {}  # id(module) -> its parameters' name prefix
        self._plans: dict[str, _Plan] = {}

    @property
    def dp(self):
        """The data axes' sub-mesh."""
        return self.mesh.sub(self.dp_axes)

    def attach(self, model: nn.Module) -> None:
        self.prefix = {id(m): (f"{n}." if n else "") for n, m in model.named_modules()}
        model.layout = self

    def plan(self, name: str) -> "_Plan":
        if name not in self._plans:
            kept = ("model",) if self.ep and name.endswith(EP_LEAVES) else ()
            self._plans[name] = _Plan(self.mesh, self.specs[name], self.shapes[name], kept)
        return self._plans[name]

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The leaf ``name`` whole (its expert split kept for EP) from this
        rank's shard ``t``; differentiable (module docstring)."""
        return _Gather.apply(t, self.plan(name))

    def view(self, module: nn.Module) -> "View":
        """A lazy stand-in for ``module`` whose parameters read whole."""
        return View(module, self, self.prefix[id(module)])


class _Plan:
    """How one leaf is gathered and its gradient reduced (module
    docstring).  ``kept``: mesh axes the leaf stays split over."""

    def __init__(self, mesh, spec, shape, kept: tuple):
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        self.mesh, self.spec, self.shape = mesh, spec, shape
        data = set(SH.DATA_AXES)
        named = SH.spec_axes(spec)
        self.group_axes = tuple(a for a in mesh.axis_names if a in named and a not in kept)
        self.group = SH.gather_axes_mesh(mesh, self.group_axes) if self.group_axes else None
        self.dims = []  # per dimension: "rep", "kept", "model" (split beyond data), "data"
        for e in spec:
            axes = SH._entry_axes(e)
            if not axes:
                self.dims.append("rep")
            elif set(axes) <= set(kept):
                self.dims.append("kept")
            elif set(axes) <= data:
                self.dims.append("data")
            elif not set(axes) & data:
                self.dims.append("model")
            else:
                raise ValueError(f"spec entry {e} mixes data and other mesh axes")
        replicated = [a for a in mesh.axis_names if a not in data and a not in named]
        reduce_axes = [a for a in mesh.axis_names if a in data] + replicated
        self.reduce = SH.gather_axes_mesh(mesh, reduce_axes)
        self.scale = 1.0 / math.prod(mesh.shape[a] for a in replicated)
        padded = SH.shard_shape(shape, spec, mesh)
        self.out_shape = tuple(n if d not in ("kept",) else p
                               for n, p, d in zip(shape, padded, self.dims))
        self.padded = tuple(p * (SH._ways(mesh, e) if d in ("data", "model") else 1)
                            for p, e, d in zip(padded, spec, self.dims))
        self.block = padded

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is not None and self.group.world > 1:
            t = SH.assemble(SH.all_gather(self.group, t), self.spec, self.mesh, self.group_axes)
        if tuple(t.shape) != self.out_shape:
            t = t[tuple(slice(0, n) for n in self.out_shape)]
        return t.contiguous()

    def _narrow(self, g: torch.Tensor, kinds) -> torch.Tensor:
        for dim, (kind, e) in enumerate(zip(self.dims, self.spec)):
            if kind in kinds:
                blk = self.block[dim]
                g = g.narrow(dim, SH._block(self.mesh, e) * blk, blk)
        return g

    def reduce_grad(self, g: torch.Tensor) -> torch.Tensor:
        if tuple(g.shape) != self.padded:  # the pad's cotangent is zero
            full = g.new_zeros(self.padded)
            full[tuple(slice(0, n) for n in g.shape)] = g
            g = full
        g = self._narrow(g, ("model",))
        if self.reduce.world > 1:
            g = SH.all_reduce(self.reduce, g.contiguous(), "sum")
        g = self._narrow(g, ("data",))
        if self.scale != 1.0:
            g = g * self.scale
        return g.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, plan):
        ctx.plan = plan
        return plan.gather(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.reduce_grad(g), None


class View:
    """Read-only stand-in for a module of a sharded model: a parameter
    reads as the gathered leaf (gathered at its first read, then kept for
    this view's life), a layer stack as the ``nn.ModuleList`` itself (each
    block is viewed where it is applied), any other submodule as a view,
    and any other attribute as the module's.  ``gathered`` tells a block
    that its weights' gradients are summed over the data ranks by the
    gathers; ``dp_mesh`` is the data axes' sub-mesh where they split the
    batch (the loss's sums, a ``sorted`` MoE's global batch), else None."""

    def __init__(self, module: nn.Module, layout: Layout, prefix: str):
        self.__dict__.update(_module=module, _layout=layout, _prefix=prefix, gathered=True,
                             dp_mesh=layout.dp if layout.batch_split else None)

    def __getattr__(self, name: str):
        mod = self.__dict__["_module"]
        params, subs = mod._parameters, mod._modules
        if name in params:
            t = params[name]
            value = None if t is None else self._layout.gather(self._prefix + name, t)
        elif name in subs:
            sub = subs[name]
            value = (sub if sub is None or isinstance(sub, nn.ModuleList)
                     else View(sub, self._layout, f"{self._prefix}{name}."))
        else:
            return getattr(mod, name)
        self.__dict__[name] = value
        return value

    def parameters(self):
        """The module's own parameters (the shards)."""
        return self._module.parameters()


def full_view(model):
    """The model to run: a :class:`View` of a sharded model (the model
    itself when it is not sharded or already a view)."""
    layout = getattr(model, "layout", None)
    if layout is None or isinstance(model, View):
        return model
    return layout.view(model)


def block_view(model):
    """``fn(block) -> block or its view``: what a layer stack applies."""
    layout = getattr(model, "layout", None)
    return None if layout is None else layout.view


@contextlib.contextmanager
def whole_batch(model, whole: bool = True):
    """While open (with ``whole``), a sharded ``model`` runs on the whole
    batch on every rank, one that does not divide the data ranks (which
    ``steps.batch_shardings`` replicates): its views carry no ``dp_mesh``,
    so no layer sums or gathers the batch over the data ranks."""
    layout = getattr(model, "layout", None)
    if layout is None or not whole:
        yield
        return
    before, layout.batch_split = layout.batch_split, False
    try:
        yield
    finally:
        layout.batch_split = before


# ---------------------------------------------------------------------------
# leaves of the optimiser on shards (by leaf path, a stack as one leaf)
# ---------------------------------------------------------------------------


class LeafLayout:
    """The optimisers' view of a sharded model: each leaf's spec (the
    reference's, by ``param_leaves`` path: a stack's has its ``"layers"``
    entry first) and global shape on ``mesh``."""

    def __init__(self, mesh, specs: dict, shapes: dict):
        self.mesh, self.specs, self.shapes = mesh, specs, shapes

    def valid(self, k: str) -> tuple:
        return SH.valid_slices(self.shapes[k], self.specs[k], self.mesh)

    def copies(self, k: str) -> int:
        """The ranks holding each block of leaf ``k`` (those of the axes its
        spec does not split)."""
        named = set(SH.spec_axes(self.specs[k]))
        return math.prod(n for a, n in self.mesh.shape.items() if a not in named)

    def _sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        if not axes or math.prod(self.mesh.shape[a] for a in axes) == 1:
            return x
        return SH.all_reduce(SH.gather_axes_mesh(self.mesh, axes), x, "sum")

    def psum(self, x: torch.Tensor, k: str, dim: int) -> torch.Tensor:
        """``x``, a sum over leaf ``k``'s dimension ``dim`` on this rank's
        block, summed over the ranks of the axes that split it."""
        spec = tuple(self.specs[k]) + (None,) * len(self.shapes[k])
        return self._sum_over(x, SH._entry_axes(spec[dim % len(self.shapes[k])]))

    def psum_all(self, x: torch.Tensor, k: str) -> torch.Tensor:
        """``x``, a sum over leaf ``k``'s block, summed over all its blocks."""
        return self._sum_over(x, SH.spec_axes(self.specs[k]))

    def size(self, k: str, dim: int) -> int:
        return int(self.shapes[k][dim])

    def total_of(self, local: torch.Tensor) -> torch.Tensor:
        """A float32 vector of per-leaf sums on this rank (each already
        divided by its leaf's copies) summed over every rank."""
        every = self.mesh.sub(self.mesh.axis_names)
        return SH.all_reduce(every, local, "sum") if every.world > 1 else local


def leaf_layout(mesh, axes: dict, shapes: dict) -> LeafLayout:
    """:class:`LeafLayout` of the leaves' logical ``axes``
    (``model.logical_axes``) and global ``shapes`` on ``mesh``."""
    rules = SH.rules_for_mesh(mesh)
    return LeafLayout(mesh, {k: SH.spec_from_axes(a, rules) for k, a in axes.items()},
                      {k: tuple(s) for k, s in shapes.items()})


def shard_bytes(shapes: dict, specs: dict, mesh, itemsize) -> int:
    """Bytes on one rank of leaves of ``shapes`` under ``specs`` (padding
    included); ``itemsize``: bytes an element, or a dict of them by leaf."""
    total = 0
    for k, shape in shapes.items():
        size = itemsize[k] if isinstance(itemsize, dict) else itemsize
        total += int(np.prod(SH.shard_shape(shape, specs[k], mesh))) * size
    return total

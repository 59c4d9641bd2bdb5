"""Checkpoints of the port (counterpart of :mod:`repro.checkpoint.manager`):
atomic manifests, async writes and retention, in the reference's layout.

    <root>/step_00000120/
        manifest.json        # leaf shapes and dtypes, step, extras
        shard_p0.npz         # the leaves, by /-joined path

* the manifest is written last and the directory renamed into place, so a
  partly written checkpoint is never visible;
* ``save(..., blocking=False)`` copies every leaf to the host first, then
  hands the copies to a writer thread, and training goes on;
* the data loader's cursor rides in the manifest's extras, so a resume
  is exactly-once with respect to the input stream;
* NumPy has no bfloat16 (without ``ml_dtypes``), so a bfloat16 tensor is
  stored as its ``uint16`` bits and the manifest names its dtype.

A tree is nested dicts, tuples, lists and named tuples whose leaves are
tensors, NumPy arrays or numbers; a model (``nn.Module``) stands for its
named parameters.  ``restore(like, device=)`` rebuilds ``like``'s
structure: a model's parameters are copied into it in place, other leaves
come back as tensors on ``device`` (by default the device of ``like``'s
tensors, else ``"cuda"``; without a card that raises: the port never
moves to the CPU unless asked; numbers as numbers).

On a mesh of ranks the checkpoint is the one-process format, whatever mesh
wrote it (the reference's elastic restore).  A sharded model (its
``layout``) and the leaves named in ``specs`` (flattened paths, each a
spec or a :class:`Placement`) are shards: ``save(..., mesh=, specs=)``
gathers each leaf on every rank (every rank calls it; the gathers run
before ``save`` returns, since a gloo collective issued from the writer
thread beside the training's would deadlock), then the mesh's rank 0 alone
writes, on the writer thread if asked.  ``restore(like, mesh=, specs=)``
reads the whole leaves on every rank and keeps each rank's shard
(``sharding.shard_of``), on a mesh that may differ from the one that saved.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import time
import zipfile
from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.distributed import sharding as SH

_SEP = "/"


class Placement(NamedTuple):
    """A sharded leaf: its ``spec`` and its global ``shape`` (needed to
    drop an uneven shard's padding when the leaf is gathered)."""

    spec: tuple
    shape: tuple


def _children(node):
    """``[(key, child)]`` of an inner node of a tree, or None for a leaf."""
    if isinstance(node, nn.Module):
        return list(node.named_parameters())
    if isinstance(node, Mapping):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix.rstrip(_SEP): tree}
    out = {}
    for key, sub in kids:
        out.update(_flatten(sub, f"{prefix}{key}{_SEP}"))
    return out


def to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A host copy of a leaf and the dtype name the manifest records
    (``bfloat16`` for a bfloat16 tensor, stored as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)  # a CPU tensor's storage would be shared
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf)
    return a, str(a.dtype)


def from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _stored_arrays(path: str) -> dict:
    """The arrays of an ``.npz`` written by :func:`_write`, by name, each a
    read-only ``np.memmap`` of its bytes in the file (``np.savez`` stores
    them uncompressed), so that a rank reading its shard of a leaf reads
    only those rows; a compressed member is read whole."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename.removesuffix(".npy")
            if info.compress_type == zipfile.ZIP_STORED:
                f.seek(info.header_offset + 26)  # the local header's name and extra lengths
                n_name, n_extra = struct.unpack("<HH", f.read(4))
                f.seek(info.header_offset + 30 + n_name + n_extra)
                version = np.lib.format.read_magic(f)
                read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                shape, fortran, dtype = read(f)
                if not dtype.hasobject and shape and 0 not in shape:
                    out[name] = np.memmap(path, dtype=dtype, mode="r", offset=f.tell(),
                                          shape=shape, order="F" if fortran else "C")
                    continue
            out[name] = np.load(io.BytesIO(zf.read(info)))
    return out


def _placements(tree, specs: Mapping | None, prefix: str = "") -> dict:
    """Flattened path -> (spec, global shape or None) of every sharded leaf:
    a sharded model's parameters (its ``layout``) and ``specs``' entries."""
    out = {}
    kids = _children(tree)
    layout = getattr(tree, "layout", None) if isinstance(tree, nn.Module) else None
    if layout is not None:
        for name, _ in kids:
            out[f"{prefix}{name}"] = (layout.specs[name], layout.shapes[name])
    elif kids is not None and not isinstance(tree, nn.Module):
        for key, sub in kids:
            out.update(_placements(sub, None, f"{prefix}{key}{_SEP}"))
    for k, v in (specs or {}).items():
        out[k] = (v.spec, v.shape) if isinstance(v, Placement) else (tuple(v), None)
    return out


def _mesh_of(tree, mesh):
    """The mesh a tree's shards live on: ``mesh``, else a sharded model's."""
    if mesh is not None:
        return mesh
    for node in [tree] + [sub for _, sub in (_children(tree) or [])]:
        layout = getattr(node, "layout", None) if isinstance(node, nn.Module) else None
        if layout is not None:
            return layout.mesh
    return None


def gathered_host(tree, *, mesh=None, specs: Mapping | None = None):
    """``(host leaves or None, writer)``: every sharded leaf gathered whole
    (a collective: every rank of the mesh calls this, in one order) and, on
    the writer (rank 0 of the mesh, or the one process), every leaf copied
    to the host."""
    mesh = _mesh_of(tree, mesh)
    placed = _placements(tree, specs)
    if placed and mesh is None:
        raise ValueError("sharded leaves need the mesh they live on (mesh=)")
    writer = mesh is None or mesh.rank == 0
    host = {}
    for k, v in _flatten(tree).items():
        if k in placed:
            spec, shape = placed[k]
            v = SH.gather_full(v, spec, mesh, shape)
        if writer:
            host[k] = to_numpy(v)
    return (host if writer else None), writer


def _write(host: dict, directory: str, *, step: int, extras: dict | None) -> None:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "shard_p0.npz"),
             **{k: a for k, (a, _) in host.items()})
    manifest = {
        "step": step,
        "time": time.time(),
        "extras": extras or {},
        "leaves": {k: {"shape": list(a.shape), "dtype": dt} for k, (a, dt) in host.items()},
        "num_processes": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)  # atomic publish


def save_pytree(tree, directory: str, *, step: int, extras: dict | None = None, mesh=None,
                specs: Mapping | None = None) -> None:
    """Write ``tree``'s leaves and the manifest to ``directory`` (on a mesh:
    module docstring)."""
    host, writer = gathered_host(tree, mesh=mesh, specs=specs)
    if writer:
        _write(host, directory, step=step, extras=extras)


def _like_device(tree_like) -> torch.device:
    """The device of ``tree_like``'s tensors (a model's: its parameters'),
    else ``"cuda"``, which raises without a card."""
    for v in _flatten(tree_like).values():
        if isinstance(v, torch.Tensor) and v.device.type != "meta":
            return v.device
    return resolve_device("cuda")


def _rebuild(like, flat: dict, prefix: str, device):
    kids = _children(like)
    if kids is None:
        value = flat[prefix.rstrip(_SEP)]
        if isinstance(like, (bool, int, float)):
            return type(like)(value.item())
        return value.to(device)
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for key, t in kids:
                value = flat[f"{prefix}{key}"]
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(f"{prefix}{key}: stored {tuple(value.shape)}, model "
                                     f"{tuple(t.shape)}")
                t.copy_(value)
        return like
    values = [_rebuild(sub, flat, f"{prefix}{key}{_SEP}", device) for key, sub in kids]
    if isinstance(like, Mapping):
        return type(like)(zip(like.keys(), values))
    if hasattr(like, "_fields"):
        return type(like)(*values)
    return type(like)(values)


def restore_pytree(tree_like, directory: str, *, device=None, mesh=None,
                   specs: Mapping | None = None):
    """``(tree, manifest)``: the stored leaves in ``tree_like``'s structure
    (see the module's docstring), tensors on ``device`` (default: where
    ``tree_like``'s are; on a mesh, its ranks').  On a ``mesh``, each
    sharded leaf (a sharded model's parameters and ``specs``' entries) is
    this rank's shard of the stored one."""
    mesh = _mesh_of(tree_like, mesh)
    if device is None:
        device = mesh.device if mesh is not None else _like_device(tree_like)
    placed = _placements(tree_like, specs)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    data = _stored_arrays(os.path.join(directory, "shard_p0.npz"))
    flat = {}
    for k in _flatten(tree_like):
        a, dtype = data[k], manifest["leaves"][k]["dtype"]
        if k in placed:  # only this rank's rows are read
            slices, padded = SH.block_slices(a.shape, placed[k][0], mesh)
            flat[k] = SH.padded_to(from_numpy(a[slices], dtype), padded)
        else:
            flat[k] = from_numpy(a, dtype)
    del data
    return _rebuild(tree_like, flat, "", resolve_device(device)), manifest


class CheckpointManager:
    """Step-granular manager with retention (the newest ``keep``) and async
    saves."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.root)
                      if d.startswith("step_") and not d.endswith(".tmp")
                      and os.path.exists(os.path.join(self.root, d, "manifest.json")))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Wait for the async save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, tree, step: int, *, extras=None, blocking: bool = True, mesh=None,
             specs: Mapping | None = None) -> None:
        """Save ``tree`` as ``step`` (on a mesh every rank calls it: module
        docstring)."""
        self.wait()
        # on the host before control returns (training may go on), every
        # gather made here, on the caller's thread
        host, writer = gathered_host(tree, mesh=mesh, specs=specs)
        if not writer:
            return

        def write():
            try:
                _write(host, self._dir(step), step=step, extras=extras)
                self._gc()
            except Exception as e:  # noqa: BLE001  (raised again by wait())
                self._error = e

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def restore(self, tree_like, *, step: int | None = None, device=None, mesh=None,
                specs: Mapping | None = None):
        """``(tree, manifest)`` of ``step`` (the latest by default), or
        ``(None, None)`` where there is none (:func:`restore_pytree`)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return restore_pytree(tree_like, self._dir(step), device=device, mesh=mesh, specs=specs)

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

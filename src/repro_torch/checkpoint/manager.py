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
come back as tensors on ``device`` (numbers as numbers).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_SEP = "/"


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
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _host(tree) -> dict[str, tuple[np.ndarray, str]]:
    return {k: to_numpy(v) for k, v in _flatten(tree).items()}


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


def save_pytree(tree, directory: str, *, step: int, extras: dict | None = None) -> None:
    """Write ``tree``'s leaves and the manifest to ``directory``."""
    _write(_host(tree), directory, step=step, extras=extras)


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


def restore_pytree(tree_like, directory: str, *, device="cpu"):
    """``(tree, manifest)``: the stored leaves in ``tree_like``'s structure
    (see the module's docstring), tensors on ``device``."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, "shard_p0.npz")) as data:
        flat = {k: from_numpy(data[k], manifest["leaves"][k]["dtype"])
                for k in _flatten(tree_like)}
    return _rebuild(tree_like, flat, "", torch.device(device)), manifest


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

    def save(self, tree, step: int, *, extras=None, blocking: bool = True) -> None:
        self.wait()
        host = _host(tree)  # on the host before control returns: training may go on

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

    def restore(self, tree_like, *, step: int | None = None, device="cpu"):
        """``(tree, manifest)`` of ``step`` (the latest by default), or
        ``(None, None)`` where there is none."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return restore_pytree(tree_like, self._dir(step), device=device)

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

"""Build and load the CUDA kernels of :mod:`repro_torch.kernels`.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use, into ``build/repro_torch_kernels/<hash>/`` at the
repository root, keyed by a hash of every source and the compiler flags;
:func:`build_all` starts one ``nvcc`` per source, all at once.  Nothing is
compiled when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("argsort", "segmented_combine", "merge_path", "join_probe", "grouped_matmul",
           "merge_aggregate")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each source built by
# this process
PTXAS_REPORT: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every missing library in parallel; returns their paths."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: out / f"lib{name}.so" for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        PTXAS_REPORT[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _libs:
            path = build_all()[name]
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


# ---------------------------------------------------------------------------
# binding helpers shared by the wrappers
# ---------------------------------------------------------------------------

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong


_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def fn(name: str, symbol: str, argtypes, restype=I):
    """A C function of ``csrc/<name>.cu`` with its signature declared (kept
    after the first call: the wrappers run on every launch)."""
    f = _fns.get((name, symbol))
    if f is None:
        f = getattr(lib(name), symbol)
        f.argtypes = argtypes
        f.restype = restype
        _fns[(name, symbol)] = f
    return f


def check(t, dtype, what: str, *, ndim: int, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank
    ``ndim`` (on ``device`` when given)."""
    import torch

    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        dev = t.device if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got {dev}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} of shape {tuple(t.shape)} (contiguous={t.is_contiguous()})"
        )


def check_state(state, what: str) -> None:
    """Raise unless ``state`` is a 1-D-row AggState the kernels take."""
    import torch

    n = state.keys.shape[0]
    check(state.keys, torch.int64, f"{what}.keys", ndim=1)
    dev = state.keys.device
    check(state.count, torch.int32, f"{what}.count", ndim=1, device=dev)
    for f in ("sum", "min", "max"):
        check(getattr(state, f), torch.float32, f"{what}.{f}", ndim=2, device=dev)
    if any(getattr(state, f).shape[0] != n for f in ("count", "sum", "min", "max")):
        raise ValueError(f"{what}: fields disagree on the row count {n}")
    if n >= 1 << 31:
        raise ValueError(f"{what}: {n} rows; the kernels index rows with 32-bit counts")
    if 1 + sum(state.widths) > 25:
        raise ValueError(f"{what}: plane widths {state.widths} exceed the kernels' 24 columns")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err}")

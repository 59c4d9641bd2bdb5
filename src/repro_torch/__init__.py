"""PyTorch/CUDA port of the in-sort duplicate removal, grouping and
aggregation operator (Do & Graefe), for NVIDIA Hopper, with the operators
that consume its sorted output (merge join, rollup, ``pipeline``) and its
serving sessions (``serve_aggregate``).

The JAX package ``repro`` is the reference; this package imports nothing
of it.  Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, where the kernels' plain PyTorch versions run.
"""
from repro_torch.core.schema import (
    AggResult,
    AggSpec,
    JoinResult,
    KeyColumn,
    KeySpec,
    aggregate,
    pipeline,
    rollup,
    serve_aggregate,
)
from repro_torch.core.types import ExecConfig

__all__ = ["aggregate", "rollup", "pipeline", "serve_aggregate", "AggResult", "JoinResult",
           "AggSpec", "KeySpec", "KeyColumn", "ExecConfig"]

"""The port's engine (counterpart of :mod:`repro.core`): types, backend
registry, the plain reference engine and its typed layer
(``OrderedIndex``), run generation, the traditional and wide merges, the
device pipeline one-shot and streamed, the adaptive policy governor, the
paper's operator and its baselines (hash, F1-hash, sort-then-stream,
in-stream), the operators built on them, the cost model and the front
door.
"""
from repro_torch.core import cost_model
from repro_torch.core.dispatch import Backend, get_backend, registered_backends
from repro_torch.core.hash_agg import f1_hash_aggregate, hash_aggregate
from repro_torch.core.insort import insort_aggregate, sort_then_stream_aggregate
from repro_torch.core.instream import instream_aggregate
from repro_torch.core.operators import (
    count_and_count_distinct,
    distinct,
    group_by,
    group_by_order_by,
    intersect_distinct,
    pack_keys,
    rollup,
    unpack_keys,
)
from repro_torch.core.ordered_index import OrderedIndex, merge_ranks
from repro_torch.core.pipeline import (
    aggregate_device,
    generate_runs_device,
    insort_aggregate_device,
)
from repro_torch.core.schema import AggResult, AggSpec, KeyColumn, KeySpec, aggregate
from repro_torch.core.sorted_ops import (
    finalize,
    interleave,
    interleave_many,
    merge_absorb,
    merge_absorb_many,
    segmented_combine,
    sort_state,
    sorted_groupby,
)
from repro_torch.core.types import (
    AggState,
    DeviceSpillStats,
    ExecConfig,
    SpillStats,
    empty_key,
    key_dtype_for_bits,
    max_key,
)

__all__ = [
    "AggState", "DeviceSpillStats", "ExecConfig", "SpillStats", "empty_key",
    "key_dtype_for_bits", "max_key", "AggResult", "AggSpec", "KeyColumn", "KeySpec",
    "aggregate", "Backend", "get_backend", "registered_backends", "OrderedIndex",
    "merge_ranks", "sorted_groupby",
    "finalize", "sort_state", "segmented_combine", "interleave", "interleave_many",
    "merge_absorb", "merge_absorb_many", "insort_aggregate", "aggregate_device",
    "generate_runs_device", "insort_aggregate_device", "sort_then_stream_aggregate",
    "hash_aggregate", "f1_hash_aggregate", "instream_aggregate", "group_by", "distinct",
    "group_by_order_by", "count_and_count_distinct", "rollup", "intersect_distinct",
    "pack_keys", "unpack_keys", "cost_model",
]

"""The mesh of the port (counterpart of :mod:`repro.distributed`): one
process per rank, joined by ``torch.distributed`` (:mod:`.sharding`: 1-D
and named-axis meshes, the collectives, the differentiable ones); the
key-range exchange of sharded aggregation (:mod:`.groupby`); expert
parallelism (:mod:`.moe_parallel`), the ring all-gather matmul
(:mod:`.overlap`) and GPipe (:mod:`.pipeline`)."""

"""Mesh-sharded aggregation of the port (counterpart of
:mod:`repro.distributed`): one process per shard, joined by
``torch.distributed`` (:mod:`.sharding`), and the key-range exchange
(:mod:`.groupby`)."""

"""Measured per-row costs of the engine's primitives: the port's copy of
the JAX package's committed table, keyed by device type.

The ``cpu`` entry was measured on a CPU by the JAX package's calibration
(``benchmarks/calibrate.py``, through its XLA backend); it is the port's
floor until a calibration run of the port on the card adds a ``"cuda"``
entry.  Every device without an entry uses the ``cpu`` one.

All figures are nanoseconds per input row.  ``absorb_row_ns`` is the
per-row cost of one absorb step under each run-generation policy
(including the batch sort that policy pays); ``sort_row_ns`` is that
batch sort alone, so a caller with pre-sorted input can subtract it
(:func:`repro_torch.core.cost_model.policy_cost_per_row`).
"""

COST_SCHEMA_VERSION = 1

COST_CONSTANTS = {'cpu': {'absorb_dup_row_ns': {'early_agg': 2153.875,
                               'inrun_dedup': 1969.199,
                               'rs': 4484.207,
                               'traditional': 1321.41},
         'absorb_row_ns': {'early_agg': 2318.234,
                           'inrun_dedup': 2079.238,
                           'rs': 5498.202,
                           'traditional': 1402.548},
         'hash_probe_row_ns': 421.773,
         'merge_row_ns': 165.798,
         'meta': {'backend': 'cpu',
                  'dispatch_backend': 'xla',
                  'generated_by': 'benchmarks/calibrate.py',
                  'note': 'memory_rows=4096 batch_rows=1024 n_rows=65536 '
                          'iters=3',
                  'smoke': False},
         'schema_version': 1,
         'sort_row_ns': 43.155,
         'spill_write_row_ns': 16.976}}

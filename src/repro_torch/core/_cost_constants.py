"""Measured per-row costs of the engine's primitives, keyed by torch device
type.

AUTOGENERATED by ``scripts/calibrate_torch.py`` — do not edit by hand;
run the calibration again on new hardware instead.  The ``cpu`` entry is
the JAX package's committed one (``benchmarks/calibrate.py`` on a CPU,
through its XLA backend); the ``cuda`` entry was measured on an NVIDIA
H100 by ``scripts/calibrate_torch.py`` (its ``meta`` names the card, the
power limit and the configuration).  Every device without an entry uses
the ``cpu`` one.

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
         'spill_write_row_ns': 16.976},
 'cuda': {'absorb_dup_row_ns': {'early_agg': 26.691,
                                'inrun_dedup': 15.317,
                                'rs': 41.315,
                                'traditional': 17.87},
          'absorb_row_ns': {'early_agg': 24.969,
                            'inrun_dedup': 17.382,
                            'rs': 48.057,
                            'traditional': 16.235},
          'hash_probe_row_ns': 64.225,
          'merge_row_ns': 0.058,
          'meta': {'backend': 'cuda',
                   'device': 'NVIDIA H100 80GB HBM3, 700.00 W',
                   'dispatch_backend': 'cuda',
                   'generated_by': 'scripts/calibrate_torch.py',
                   'note': 'memory_rows=1048576 batch_rows=65536 '
                           'page_rows=16384 fanin=16 n_rows=16777216 '
                           'chunk_rows=1048576 iters=3; NVIDIA H100 80GB '
                           'HBM3, 700.00 W; least of the iterations '
                           '(spread_ns: least, most); hash_probe_row_ns '
                           "times the host's NumPy hash aggregation, which "
                           'core/hash_agg.py runs for every device',
                   'smoke': False,
                   'spread_ns': {'absorb_dup_row_ns.early_agg': [26.691,
                                                                 28.189],
                                 'absorb_dup_row_ns.inrun_dedup': [15.317,
                                                                   18.619],
                                 'absorb_dup_row_ns.rs': [41.315, 43.48],
                                 'absorb_dup_row_ns.traditional': [17.87,
                                                                   20.578],
                                 'absorb_row_ns.early_agg': [24.969,
                                                             32.649],
                                 'absorb_row_ns.inrun_dedup': [17.382,
                                                               25.882],
                                 'absorb_row_ns.rs': [48.057, 52.068],
                                 'absorb_row_ns.traditional': [16.235,
                                                               19.552],
                                 'hash_probe_row_ns': [64.225, 76.386],
                                 'merge_row_ns': [0.058, 0.061],
                                 'sort_row_ns': [0.183, 0.192],
                                 'spill_write_row_ns': [0.072, 0.086]}},
          'schema_version': 1,
          'sort_row_ns': 0.183,
          'spill_write_row_ns': 0.072}}
